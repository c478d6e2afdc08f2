// Native open-set detection (OSOD) evaluation kernels for runia_core_tpu_torch.
//
// The reference's open-set evaluator (runia_core/evaluation/open_set.py:
// 793-863, 909-954) walks every detection in a Python loop: greedy TP/FP
// assignment against per-image ground truth, and unknown-overlap flagging.
// At BDD100k scale (hundreds of thousands of detections x ~20 classes) that
// loop is the wall-clock of the whole evaluation. These kernels do the same
// walk in C++ over flattened per-image GT tables; the greedy matcher is
// inherently sequential (detections claim GT boxes in confidence order) but
// the per-step work is a handful of flops, and the unknown-overlap pass is
// embarrassingly parallel across detections.
//
// Semantics are bit-identical to the Python path (tests enforce):
//   - VOC +1 pixel IoU convention (reference open_set.py:957-993)
//   - strict `iou > thresh` acceptance
//   - first-maximum argmax tie-breaking (matches np.argmax)
//   - difficult GT: neither TP nor FP; already-claimed GT: FP
//   - det_img_idx < 0 (image absent from GT records): neither TP nor FP
//
// Built as a plain CPython extension (no pybind11 dependency) by
// runia_core_tpu_torch/_kernels.py::osod_matcher with the host's C++ compiler,
// at first use, into build/torch_kernels/.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <cstdint>
#include <vector>

#include "parallel_util.h"

namespace {

using runia_native::parallel_for;

// IoU of one box vs one GT box with the VOC +1 pixel convention.
inline double voc_iou(const double* gt, const double* bb) {
  const double ixmin = std::max(gt[0], bb[0]);
  const double iymin = std::max(gt[1], bb[1]);
  const double ixmax = std::min(gt[2], bb[2]);
  const double iymax = std::min(gt[3], bb[3]);
  const double iw = std::max(ixmax - ixmin + 1.0, 0.0);
  const double ih = std::max(iymax - iymin + 1.0, 0.0);
  const double inters = iw * ih;
  const double uni = (bb[2] - bb[0] + 1.0) * (bb[3] - bb[1] + 1.0) +
                     (gt[2] - gt[0] + 1.0) * (gt[3] - gt[1] + 1.0) - inters;
  return inters / uni;
}

// Max IoU over a GT range plus the argmax (first maximum, like np.argmax).
inline void max_iou(const double* gt_boxes, int64_t begin, int64_t count,
                    const double* bb, double* best, int64_t* best_j) {
  *best = -1e300;
  *best_j = -1;
  for (int64_t j = 0; j < count; ++j) {
    const double iou = voc_iou(gt_boxes + (begin + j) * 4, bb);
    if (iou > *best) {
      *best = iou;
      *best_j = j;
    }
  }
}

struct GtTable {
  const int64_t* img_idx;    // (nd,) per-detection image index, -1 = absent
  const double* det_boxes;   // (nd, 4)
  const int64_t* offsets;    // (n_img,) start of each image's GT rows
  const int64_t* counts;     // (n_img,)
  const double* gt_boxes;    // (ngt, 4)
  int64_t nd;
  int64_t n_img;
  int64_t ngt;
};

bool parse_table(Py_buffer* img_idx, Py_buffer* det_boxes, Py_buffer* offsets,
                 Py_buffer* counts, Py_buffer* gt_boxes, GtTable* t) {
  t->img_idx = static_cast<const int64_t*>(img_idx->buf);
  t->det_boxes = static_cast<const double*>(det_boxes->buf);
  t->offsets = static_cast<const int64_t*>(offsets->buf);
  t->counts = static_cast<const int64_t*>(counts->buf);
  t->gt_boxes = static_cast<const double*>(gt_boxes->buf);
  t->nd = img_idx->len / static_cast<int64_t>(sizeof(int64_t));
  t->n_img = offsets->len / static_cast<int64_t>(sizeof(int64_t));
  t->ngt = gt_boxes->len / static_cast<int64_t>(4 * sizeof(double));
  if (det_boxes->len < static_cast<Py_ssize_t>(t->nd * 4 * sizeof(double)) ||
      counts->len < static_cast<Py_ssize_t>(t->n_img * sizeof(int64_t))) {
    return false;
  }
  for (int64_t d = 0; d < t->nd; ++d) {
    if (t->img_idx[d] >= t->n_img) return false;
  }
  for (int64_t i = 0; i < t->n_img; ++i) {
    if (t->offsets[i] < 0 || t->counts[i] < 0 ||
        t->offsets[i] + t->counts[i] > t->ngt) {
      return false;
    }
  }
  return true;
}

// greedy_match(det_img_idx, det_boxes, gt_offsets, gt_counts, gt_boxes,
//              gt_difficult, ovthresh, tp_out, fp_out)
//
// Sequential greedy TP/FP assignment in detection order (callers pass
// detections pre-sorted by descending confidence). tp/fp are f64 0/1 flags
// per detection (pre-cumsum, exactly what the Python loop produces).
PyObject* greedy_match(PyObject*, PyObject* args) {
  Py_buffer img_idx, det_boxes, offsets, counts, gt_boxes, difficult, tp, fp;
  double ovthresh;
  if (!PyArg_ParseTuple(args, "y*y*y*y*y*y*d" "w*w*", &img_idx, &det_boxes,
                        &offsets, &counts, &gt_boxes, &difficult, &ovthresh,
                        &tp, &fp)) {
    return nullptr;
  }
  GtTable t;
  bool ok = parse_table(&img_idx, &det_boxes, &offsets, &counts, &gt_boxes, &t);
  const uint8_t* diff_ptr = static_cast<const uint8_t*>(difficult.buf);
  double* tp_ptr = static_cast<double*>(tp.buf);
  double* fp_ptr = static_cast<double*>(fp.buf);
  ok = ok && difficult.len >= static_cast<Py_ssize_t>(t.ngt) &&
       tp.len >= static_cast<Py_ssize_t>(t.nd * sizeof(double)) &&
       fp.len >= static_cast<Py_ssize_t>(t.nd * sizeof(double));
  if (!ok) {
    PyBuffer_Release(&img_idx);
    PyBuffer_Release(&det_boxes);
    PyBuffer_Release(&offsets);
    PyBuffer_Release(&counts);
    PyBuffer_Release(&gt_boxes);
    PyBuffer_Release(&difficult);
    PyBuffer_Release(&tp);
    PyBuffer_Release(&fp);
    PyErr_SetString(PyExc_ValueError, "bad index or buffer size mismatch");
    return nullptr;
  }

  Py_BEGIN_ALLOW_THREADS;
  std::vector<uint8_t> claimed(static_cast<size_t>(t.ngt), 0);
  for (int64_t d = 0; d < t.nd; ++d) {
    tp_ptr[d] = 0.0;
    fp_ptr[d] = 0.0;
    const int64_t img = t.img_idx[d];
    if (img < 0) continue;  // image absent from GT records: skip entirely
    const int64_t begin = t.offsets[img];
    const int64_t count = t.counts[img];
    double ovmax;
    int64_t jmax;
    max_iou(t.gt_boxes, begin, count, t.det_boxes + d * 4, &ovmax, &jmax);
    if (jmax >= 0 && ovmax > ovthresh) {
      const int64_t g = begin + jmax;
      if (!diff_ptr[g]) {
        if (!claimed[g]) {
          tp_ptr[d] = 1.0;
          claimed[g] = 1;
        } else {
          fp_ptr[d] = 1.0;
        }
      }
    } else {
      fp_ptr[d] = 1.0;
    }
  }
  Py_END_ALLOW_THREADS;

  PyBuffer_Release(&img_idx);
  PyBuffer_Release(&det_boxes);
  PyBuffer_Release(&offsets);
  PyBuffer_Release(&counts);
  PyBuffer_Release(&gt_boxes);
  PyBuffer_Release(&difficult);
  PyBuffer_Release(&tp);
  PyBuffer_Release(&fp);
  Py_RETURN_NONE;
}

// max_overlap_flags(det_img_idx, det_boxes, gt_offsets, gt_counts, gt_boxes,
//                   ovthresh, num_threads, flags_out)
//
// flags[d] = 1.0 iff the detection's max IoU against its image's GT rows
// strictly exceeds ovthresh. No claiming — parallel across detections.
PyObject* max_overlap_flags(PyObject*, PyObject* args) {
  Py_buffer img_idx, det_boxes, offsets, counts, gt_boxes, flags;
  double ovthresh;
  int num_threads;
  if (!PyArg_ParseTuple(args, "y*y*y*y*y*di" "w*", &img_idx, &det_boxes,
                        &offsets, &counts, &gt_boxes, &ovthresh, &num_threads,
                        &flags)) {
    return nullptr;
  }
  GtTable t;
  bool ok = parse_table(&img_idx, &det_boxes, &offsets, &counts, &gt_boxes, &t);
  double* flags_ptr = static_cast<double*>(flags.buf);
  ok = ok && flags.len >= static_cast<Py_ssize_t>(t.nd * sizeof(double));
  if (!ok) {
    PyBuffer_Release(&img_idx);
    PyBuffer_Release(&det_boxes);
    PyBuffer_Release(&offsets);
    PyBuffer_Release(&counts);
    PyBuffer_Release(&gt_boxes);
    PyBuffer_Release(&flags);
    PyErr_SetString(PyExc_ValueError, "bad index or buffer size mismatch");
    return nullptr;
  }

  Py_BEGIN_ALLOW_THREADS;
  parallel_for(t.nd, num_threads, [&](int64_t begin_d, int64_t end_d) {
    for (int64_t d = begin_d; d < end_d; ++d) {
      flags_ptr[d] = 0.0;
      const int64_t img = t.img_idx[d];
      if (img < 0) continue;
      double ovmax;
      int64_t jmax;
      max_iou(t.gt_boxes, t.offsets[img], t.counts[img], t.det_boxes + d * 4,
              &ovmax, &jmax);
      if (jmax >= 0 && ovmax > ovthresh) flags_ptr[d] = 1.0;
    }
  });
  Py_END_ALLOW_THREADS;

  PyBuffer_Release(&img_idx);
  PyBuffer_Release(&det_boxes);
  PyBuffer_Release(&offsets);
  PyBuffer_Release(&counts);
  PyBuffer_Release(&gt_boxes);
  PyBuffer_Release(&flags);
  Py_RETURN_NONE;
}

PyMethodDef methods[] = {
    {"greedy_match", greedy_match, METH_VARARGS,
     "Greedy VOC TP/FP assignment over flattened GT tables (GIL released)."},
    {"max_overlap_flags", max_overlap_flags, METH_VARARGS,
     "Per-detection max-IoU threshold flags (GIL released, multithreaded)."},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "_runia_osod",
    "runia_core_tpu_torch native open-set evaluation kernels",
    -1, methods, nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit__runia_osod(void) { return PyModule_Create(&module); }
