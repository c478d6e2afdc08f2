#!/usr/bin/env python3
"""Multi-process dry run of the PyTorch port's data-parallel layer.

Mirrors two legs of ``__graft_entry__.py::dryrun_multichip`` with
``runia_core_tpu_torch.parallel`` on a ``torch.distributed`` world of gloo
processes on the CPU, one process per device:

* ``dp_tp``: one ``sharded_train_step`` of a small ResNet (CIFAR stem, two
  stages, 8 filters, 8 classes) on a (data, model) mesh, the batch sharded
  over ``data`` and the head's rows over ``model`` (2 when the world is
  even); the loss must be finite.
* ``larex``: a LaREM state fitted with ``fit_md_sharded`` on features
  sharded over ``data``, held to ``MDLatentSpace`` fitted on all of them,
  then a LaREx scorer on a ``SimpleConvNet`` split over the ranks by
  ``data_parallel_scorer``, whose scores must equal the single-process
  scorer's for the same generator state (1e-4).

The JAX dry run's six other legs (``sp``, ``ep``, ``pp``, ``tp``,
``engine``, ``fsdp``) need the model-parallel modules (``fsdp.py``,
``llama_tp.py``, ``ring_attention.py``, ``pipeline.py``, ``moe.py``), which
are not ported yet.

Run from the root of a checkout:

    python3 torch_multichip.py --world 4 --legs dp_tp,larex

It starts ``--world`` processes, which meet through a file in a temporary
directory, prints one line per leg and process group, and exits non-zero if
a leg fails or a process does not finish within ``--timeout`` seconds (the
processes are then killed).
"""

from __future__ import annotations

import argparse
import multiprocessing
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
LEGS = ("dp_tp", "larex")


def leg_dp_tp(world: int) -> dict:
    """One dp + tp sharded SGD step (``__graft_entry__.py:98-108``)."""
    from runia_core_tpu_torch.models import ResNet
    from runia_core_tpu_torch.models.resnet import ResNetBlock
    from runia_core_tpu_torch.parallel import make_mesh, shard_batch, sharded_train_step

    model_parallel = 2 if world % 2 == 0 else 1
    mesh = make_mesh(world, model_parallel=model_parallel, device_type="cpu")
    model = ResNet(stage_sizes=(1, 1), block_cls=ResNetBlock, num_classes=8, num_filters=8, cifar_stem=True,
                   device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    batch = world * 2
    images = torch.zeros((batch, 16, 16, 3))
    labels = torch.zeros((batch,), dtype=torch.int64)
    step = sharded_train_step(model, mesh)
    params = step.shard_params(dict(model.named_parameters()))
    params, loss = step(params, shard_batch(images, mesh), shard_batch(labels, mesh))
    if not bool(torch.isfinite(loss)):
        raise RuntimeError(f"non-finite loss {float(loss)}")
    return {"leg": "dp_tp", "mesh": list(mesh.shape), "loss": float(loss),
            "head_rows_per_rank": int(params["head.weight"].shape[0])}


def leg_larex(world: int) -> dict:
    """A sharded LaREM fit and a data-parallel LaREx scorer
    (``__graft_entry__.py:222-264``)."""
    from runia_core_tpu_torch.detectors import MDLatentSpace
    from runia_core_tpu_torch.detectors.latent import md_score
    from runia_core_tpu_torch.inference import build_larex_scorer
    from runia_core_tpu_torch.models import SimpleConvNet, build_tapped_forward
    from runia_core_tpu_torch.parallel import data_parallel_scorer, fit_md_sharded, make_mesh, shard_batch

    mesh = make_mesh(world, model_parallel=1, device_type="cpu")
    cnn = SimpleConvNet(num_classes=2, features=8, in_channels=1, device="cpu")
    cnn.init_weights(torch.Generator().manual_seed(6))
    images = torch.rand((world * 2, 16, 16, 1), generator=torch.Generator().manual_seed(5))
    forward = build_tapped_forward(cnn)

    fit_feats = torch.randn((world * 16, 16), generator=torch.Generator().manual_seed(7))
    state = fit_md_sharded(shard_batch(fit_feats, mesh), mesh)
    md = MDLatentSpace()
    md.setup(fit_feats)
    fit_err = float((md_score(fit_feats[:8], state["feats_mean"], state["precision"])
                     - md.postprocess(fit_feats[:8])).abs().max())
    np.testing.assert_allclose(md_score(fit_feats[:8], state["feats_mean"], state["precision"]).numpy(),
                               md.postprocess(fit_feats[:8]).numpy(), rtol=1e-2, atol=1e-2)

    scorer = build_larex_scorer(forward, None, state, mcd_samples_nro=8, drop_block_prob=0.4, drop_block_size=3)
    _, single = scorer(images, torch.Generator().manual_seed(8))
    _, dp = data_parallel_scorer(scorer, mesh)(images, torch.Generator().manual_seed(8))
    np.testing.assert_allclose(dp.numpy(), single.numpy(), rtol=1e-4, atol=1e-4)
    return {"leg": "larex", "mesh": list(mesh.shape), "fit_max_abs_err": fit_err,
            "scores_max_abs_err": float((dp - single).abs().max()), "scores": len(dp)}


def run_legs(rank: int, world: int, legs, init_method: str) -> list:
    """Join the gloo world as ``rank``, run ``legs`` and leave it."""
    import torch.distributed as dist

    from runia_core_tpu_torch.parallel import initialize_distributed

    torch.set_num_threads(1)
    initialize_distributed(init_method, world, rank, device_type="cpu")
    try:
        return [{"leg_dp_tp": leg_dp_tp, "leg_larex": leg_larex}[f"leg_{leg}"](world) for leg in legs]
    finally:
        dist.destroy_process_group()


def _process(rank: int, world: int, legs, init_method: str, results) -> None:
    try:
        results.put((rank, run_legs(rank, world, legs, init_method), None))
    except BaseException as exc:  # reported to the parent, which fails the run
        results.put((rank, None, f"{type(exc).__name__}: {exc}"))
        raise


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--world", type=int, default=4, help="processes (one device each)")
    parser.add_argument("--legs", default=",".join(LEGS), help=f"comma-separated subset of {','.join(LEGS)}")
    parser.add_argument("--timeout", type=float, default=300.0, help="seconds before the processes are killed")
    args = parser.parse_args()
    legs = [leg for leg in args.legs.split(",") if leg]
    unknown = sorted(set(legs) - set(LEGS))
    if unknown:
        parser.error(f"unknown legs {unknown}; ported: {list(LEGS)}")
    sys.path.insert(0, str(REPO))
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init_method = f"file://{tmp}/rendezvous"
        procs = [ctx.Process(target=_process, args=(rank, args.world, legs, init_method, results))
                 for rank in range(args.world)]
        for proc in procs:
            proc.start()
        reports, failed = {}, []
        try:
            for _ in procs:  # drain the queue before joining
                rank, records, error = results.get(timeout=args.timeout)
                reports[rank] = records
                if error:
                    failed.append(f"rank {rank}: {error}")
                    break
        except Exception as exc:  # the queue's Empty: a process hung or died
            failed.append(f"no result within {args.timeout} s ({type(exc).__name__})")
        finally:
            for proc in procs:
                proc.join(timeout=5 if failed else args.timeout)
                if proc.is_alive():
                    proc.kill()
                    proc.join()
    for record in reports.get(0) or []:
        print(f"torch_multichip({args.world}): {record}")
    if failed or any(proc.exitcode != 0 for proc in procs):
        print(f"torch_multichip({args.world}) FAILED: {failed or [p.exitcode for p in procs]}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
