// Native host-side data-path kernels for runia_core_tpu_torch.
//
// The hot byte-level work of batch assembly: uint8 -> float32 conversion
// with normalization, optional BGR->RGB channel flip (the reference's YOLO
// loader shim, runia_core/yolov8.py:41-43), gather-into-batch by index, and
// a half-pixel bilinear resize, in multithreaded C++ that releases the GIL,
// so the prefetch thread of runia_core_tpu_torch/data.py overlaps host
// preprocessing with GPU compute. The caller hands in the output buffer (a
// pinned host tensor's memory), which the kernels write in place.
//
// Built as a plain CPython extension (no pybind11 dependency) by
// runia_core_tpu_torch/_kernels.py::dataloader with the host's C++ compiler,
// at first use, into build/torch_kernels/.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <cstdint>
#include <cstring>

#include "parallel_util.h"

namespace {

using runia_native::parallel_for;

// Convert a contiguous uint8 HWC image block to float32 with scale/offset,
// optionally flipping the channel order (BGR -> RGB for C == 3).
void convert_block(const uint8_t* src, float* dst, int64_t pixels, int64_t channels,
                   float scale, float offset, bool channel_flip) {
  if (!channel_flip || channels != 3) {
    const int64_t n = pixels * channels;
    for (int64_t i = 0; i < n; ++i) {
      dst[i] = static_cast<float>(src[i]) * scale + offset;
    }
    return;
  }
  for (int64_t p = 0; p < pixels; ++p) {
    const uint8_t* s = src + p * 3;
    float* d = dst + p * 3;
    d[0] = static_cast<float>(s[2]) * scale + offset;
    d[1] = static_cast<float>(s[1]) * scale + offset;
    d[2] = static_cast<float>(s[0]) * scale + offset;
  }
}

// gather_normalize(src_bytes, indices_bytes, n_total, img_elems, channels,
//                  scale, offset, bgr_to_rgb, num_threads, out_bytes)
//
// src: (n_total, img_elems) uint8, row-major; indices: int64 batch indices;
// out: (batch, img_elems) float32 buffer supplied by the caller.
PyObject* gather_normalize(PyObject*, PyObject* args) {
  Py_buffer src, idx, out;
  Py_ssize_t n_total, img_elems, channels;
  double scale, offset;
  int bgr_to_rgb, num_threads;
  if (!PyArg_ParseTuple(args, "y*y*nnnddii" "w*", &src, &idx, &n_total, &img_elems,
                        &channels, &scale, &offset, &bgr_to_rgb, &num_threads,
                        &out)) {
    return nullptr;
  }
  const uint8_t* src_ptr = static_cast<const uint8_t*>(src.buf);
  const int64_t* idx_ptr = static_cast<const int64_t*>(idx.buf);
  float* out_ptr = static_cast<float*>(out.buf);
  const int64_t batch = idx.len / static_cast<int64_t>(sizeof(int64_t));
  const int64_t pixels = img_elems / channels;

  bool ok = true;
  for (int64_t i = 0; i < batch; ++i) {
    if (idx_ptr[i] < 0 || idx_ptr[i] >= n_total) ok = false;
  }
  if (!ok) {
    PyBuffer_Release(&src);
    PyBuffer_Release(&idx);
    PyBuffer_Release(&out);
    PyErr_SetString(PyExc_IndexError, "batch index out of range");
    return nullptr;
  }
  if (out.len < static_cast<Py_ssize_t>(batch * img_elems * sizeof(float)) ||
      src.len < static_cast<Py_ssize_t>(n_total * img_elems)) {
    PyBuffer_Release(&src);
    PyBuffer_Release(&idx);
    PyBuffer_Release(&out);
    PyErr_SetString(PyExc_ValueError, "buffer size mismatch");
    return nullptr;
  }

  Py_BEGIN_ALLOW_THREADS;
  parallel_for(batch, num_threads, [&](int64_t begin, int64_t end) {
    for (int64_t i = begin; i < end; ++i) {
      convert_block(src_ptr + idx_ptr[i] * img_elems, out_ptr + i * img_elems,
                    pixels, channels, static_cast<float>(scale),
                    static_cast<float>(offset), bgr_to_rgb != 0);
    }
  });
  Py_END_ALLOW_THREADS;

  PyBuffer_Release(&src);
  PyBuffer_Release(&idx);
  PyBuffer_Release(&out);
  Py_RETURN_NONE;
}

// normalize_u8(src_bytes, pixels, channels, scale, offset, bgr_to_rgb,
//              num_threads, out_bytes): one contiguous block.
PyObject* normalize_u8(PyObject*, PyObject* args) {
  Py_buffer src, out;
  Py_ssize_t pixels, channels;
  double scale, offset;
  int bgr_to_rgb, num_threads;
  if (!PyArg_ParseTuple(args, "y*nnddii" "w*", &src, &pixels, &channels, &scale,
                        &offset, &bgr_to_rgb, &num_threads, &out)) {
    return nullptr;
  }
  if (src.len < pixels * channels ||
      out.len < static_cast<Py_ssize_t>(pixels * channels * sizeof(float))) {
    PyBuffer_Release(&src);
    PyBuffer_Release(&out);
    PyErr_SetString(PyExc_ValueError, "buffer size mismatch");
    return nullptr;
  }
  const uint8_t* src_ptr = static_cast<const uint8_t*>(src.buf);
  float* out_ptr = static_cast<float*>(out.buf);

  Py_BEGIN_ALLOW_THREADS;
  parallel_for(pixels, num_threads, [&](int64_t begin, int64_t end) {
    convert_block(src_ptr + begin * channels, out_ptr + begin * channels,
                  end - begin, channels, static_cast<float>(scale),
                  static_cast<float>(offset), bgr_to_rgb != 0);
  });
  Py_END_ALLOW_THREADS;

  PyBuffer_Release(&src);
  PyBuffer_Release(&out);
  Py_RETURN_NONE;
}

// Bilinear resize of one uint8 HWC image into a float32 HWC buffer with
// normalization, using half-pixel centers (matches jax.image.resize
// method="bilinear" / TF2 semantics): src_x = (dst_x + 0.5) * w_in/w_out - 0.5.
void resize_one(const uint8_t* src, float* dst, int64_t h_in, int64_t w_in,
                int64_t h_out, int64_t w_out, int64_t channels, float scale,
                float offset) {
  const float ry = static_cast<float>(h_in) / static_cast<float>(h_out);
  const float rx = static_cast<float>(w_in) / static_cast<float>(w_out);
  for (int64_t y = 0; y < h_out; ++y) {
    float sy = (static_cast<float>(y) + 0.5f) * ry - 0.5f;
    sy = std::max(0.0f, std::min(sy, static_cast<float>(h_in - 1)));
    const int64_t y0 = static_cast<int64_t>(sy);
    const int64_t y1 = std::min<int64_t>(y0 + 1, h_in - 1);
    const float fy = sy - static_cast<float>(y0);
    for (int64_t x = 0; x < w_out; ++x) {
      float sx = (static_cast<float>(x) + 0.5f) * rx - 0.5f;
      sx = std::max(0.0f, std::min(sx, static_cast<float>(w_in - 1)));
      const int64_t x0 = static_cast<int64_t>(sx);
      const int64_t x1 = std::min<int64_t>(x0 + 1, w_in - 1);
      const float fx = sx - static_cast<float>(x0);
      const uint8_t* p00 = src + (y0 * w_in + x0) * channels;
      const uint8_t* p01 = src + (y0 * w_in + x1) * channels;
      const uint8_t* p10 = src + (y1 * w_in + x0) * channels;
      const uint8_t* p11 = src + (y1 * w_in + x1) * channels;
      float* d = dst + (y * w_out + x) * channels;
      for (int64_t c = 0; c < channels; ++c) {
        const float top = static_cast<float>(p00[c]) +
                          fx * (static_cast<float>(p01[c]) - static_cast<float>(p00[c]));
        const float bot = static_cast<float>(p10[c]) +
                          fx * (static_cast<float>(p11[c]) - static_cast<float>(p10[c]));
        d[c] = (top + fy * (bot - top)) * scale + offset;
      }
    }
  }
}

// gather_resize_normalize(src_bytes, indices_bytes, n_total, h_in, w_in,
//                         channels, h_out, w_out, scale, offset, num_threads,
//                         out_bytes)
PyObject* gather_resize_normalize(PyObject*, PyObject* args) {
  Py_buffer src, idx, out;
  Py_ssize_t n_total, h_in, w_in, channels, h_out, w_out;
  double scale, offset;
  int num_threads;
  if (!PyArg_ParseTuple(args, "y*y*nnnnnnddi" "w*", &src, &idx, &n_total, &h_in,
                        &w_in, &channels, &h_out, &w_out, &scale, &offset,
                        &num_threads, &out)) {
    return nullptr;
  }
  const uint8_t* src_ptr = static_cast<const uint8_t*>(src.buf);
  const int64_t* idx_ptr = static_cast<const int64_t*>(idx.buf);
  float* out_ptr = static_cast<float*>(out.buf);
  const int64_t batch = idx.len / static_cast<int64_t>(sizeof(int64_t));
  const int64_t in_elems = h_in * w_in * channels;
  const int64_t out_elems = h_out * w_out * channels;

  bool ok = h_out > 0 && w_out > 0;
  for (int64_t i = 0; i < batch; ++i) {
    if (idx_ptr[i] < 0 || idx_ptr[i] >= n_total) ok = false;
  }
  if (!ok || src.len < static_cast<Py_ssize_t>(n_total * in_elems) ||
      out.len < static_cast<Py_ssize_t>(batch * out_elems * sizeof(float))) {
    PyBuffer_Release(&src);
    PyBuffer_Release(&idx);
    PyBuffer_Release(&out);
    PyErr_SetString(PyExc_ValueError, "bad index or buffer size mismatch");
    return nullptr;
  }

  Py_BEGIN_ALLOW_THREADS;
  parallel_for(batch, num_threads, [&](int64_t begin, int64_t end) {
    for (int64_t i = begin; i < end; ++i) {
      resize_one(src_ptr + idx_ptr[i] * in_elems, out_ptr + i * out_elems,
                 h_in, w_in, h_out, w_out, channels, static_cast<float>(scale),
                 static_cast<float>(offset));
    }
  });
  Py_END_ALLOW_THREADS;

  PyBuffer_Release(&src);
  PyBuffer_Release(&idx);
  PyBuffer_Release(&out);
  Py_RETURN_NONE;
}

PyMethodDef methods[] = {
    {"gather_normalize", gather_normalize, METH_VARARGS,
     "Gather uint8 rows by index into a normalized float32 batch (GIL released)."},
    {"normalize_u8", normalize_u8, METH_VARARGS,
     "Normalize a contiguous uint8 block to float32 (GIL released)."},
    {"gather_resize_normalize", gather_resize_normalize, METH_VARARGS,
     "Gather + bilinear-resize (half-pixel) + normalize uint8 images (GIL released)."},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "_runia_dataloader", "runia_core_tpu_torch native data-path kernels",
    -1, methods, nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit__runia_dataloader(void) { return PyModule_Create(&module); }
