#!/usr/bin/env python3
"""Multi-process dry run of the PyTorch port's parallel layer.

Mirrors the eight legs of ``__graft_entry__.py::dryrun_multichip`` with
``runia_core_tpu_torch.parallel`` on a ``torch.distributed`` world of gloo
processes on the CPU, one process per device:

* ``dp_tp``: one ``sharded_train_step`` of a small ResNet (CIFAR stem, two
  stages, 8 filters, 8 classes) on a (data, model) mesh, the batch sharded
  over ``data`` and the head's rows over ``model`` (2 when the world is
  even); the loss must be finite.
* ``sp``: ``ring_attention`` with the sequence sharded over every rank,
  causal; the output must equal dense attention (1e-5).
* ``ep``: ``sharded_moe_ffn``, tokens over ``data`` and 2 experts a rank
  over ``model``, top-2; the output must be finite.
* ``pp``: ``pipeline_apply``, one residual block a rank, 4 microbatches;
  the output must equal the blocks applied in sequence (1e-5).
* ``tp``: a Llama with every sharded width a multiple of the world
  (vocabulary, heads, hidden) made tensor-parallel by ``shard_llama_params``
  over all ranks; its logits must equal the unsharded model's (1e-5).
* ``engine``: ``ContinuousBatchingEngine`` over that tensor-parallel model
  (2 slots, chunked prefill of 8) decodes 4 tokens for each of two
  prompts, the unsharded engine's tokens.
* ``fsdp``: one ``fsdp_train_step`` of the ``dp_tp`` ResNet with leaves of
  64 elements and more sharded over ``data``; the loss must be finite and
  some leaf sharded.
* ``larex``: a LaREM state fitted with ``fit_md_sharded`` on features
  sharded over ``data``, held to ``MDLatentSpace`` fitted on all of them,
  then a LaREx scorer on a ``SimpleConvNet`` split over the ranks by
  ``data_parallel_scorer``, whose scores must equal the single-process
  scorer's for the same generator state (1e-4).

Run from the root of a checkout:

    python3 torch_multichip.py --world 4

It starts ``--world`` processes (``--legs`` picks a subset), which meet
through a file in a temporary directory, prints one line per leg and
process group, and exits non-zero if a leg fails or a process does not
finish within ``--timeout`` seconds (the processes are then killed).
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
LEGS = ("dp_tp", "sp", "ep", "pp", "tp", "engine", "fsdp", "larex")


def _resnet():
    """The dry run's small ResNet, seeded."""
    from runia_core_tpu_torch.models import ResNet
    from runia_core_tpu_torch.models.resnet import ResNetBlock

    model = ResNet(stage_sizes=(1, 1), block_cls=ResNetBlock, num_classes=8, num_filters=8, cifar_stem=True,
                   device="cpu")
    return model.init_weights(torch.Generator().manual_seed(0))


def _model_parallel(world: int) -> int:
    return 2 if world % 2 == 0 else 1


def leg_dp_tp(world: int) -> dict:
    """One dp + tp sharded SGD step (``__graft_entry__.py:98-108``)."""
    from runia_core_tpu_torch.parallel import make_mesh, shard_batch, sharded_train_step

    mesh = make_mesh(world, model_parallel=_model_parallel(world), device_type="cpu")
    model = _resnet()
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


def leg_sp(world: int) -> dict:
    """Ring attention over every rank (``__graft_entry__.py:111-120``)."""
    from runia_core_tpu_torch.parallel import make_mesh, ring_attention

    mesh = make_mesh(world, axis_names=("seq", "unused"), device_type="cpu")
    q = torch.randn((1, 2, world * 4, 8), generator=torch.Generator().manual_seed(1))
    out = ring_attention(q, q, q, mesh, seq_axis="seq", causal=True).full_tensor()
    logits = (q @ q.transpose(-1, -2)) / 8**0.5
    causal = torch.ones(logits.shape[-2:], dtype=torch.bool).tril()
    dense = torch.softmax(logits.masked_fill(~causal, float("-inf")), dim=-1) @ q
    np.testing.assert_allclose(out.numpy(), dense.numpy(), rtol=1e-5, atol=1e-5)
    return {"leg": "sp", "mesh": list(mesh.shape), "shape": list(out.shape),
            "max_abs_err": float((out - dense).abs().max())}


def leg_ep(world: int) -> dict:
    """Expert-parallel MoE, top-2 (``__graft_entry__.py:122-133``)."""
    from runia_core_tpu_torch.parallel import init_moe, make_mesh, sharded_moe_ffn

    model_parallel = _model_parallel(world)
    mesh = make_mesh(world, model_parallel=model_parallel, device_type="cpu")
    params = init_moe(torch.Generator().manual_seed(1), 8, 16, 2 * model_parallel)
    tokens = torch.randn((world * 4, 8), generator=torch.Generator().manual_seed(2))
    out = sharded_moe_ffn(params, tokens, mesh, top_k=2).full_tensor()
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError("non-finite MoE output")
    return {"leg": "ep", "mesh": list(mesh.shape), "shape": list(out.shape), "experts": 2 * model_parallel}


def leg_pp(world: int) -> dict:
    """GPipe over every rank, 4 microbatches (``__graft_entry__.py:135-145``)."""
    from runia_core_tpu_torch.parallel import make_mesh, pipeline_apply

    mesh = make_mesh(world, model_parallel=world, device_type="cpu")
    stacked = 0.2 * torch.randn((world, 8, 8), generator=torch.Generator().manual_seed(3))
    tokens = torch.randn((world * 4, 8), generator=torch.Generator().manual_seed(2))

    def block(w, x):
        return x + torch.tanh(x @ w)

    out = pipeline_apply(block, stacked, tokens, mesh, num_microbatches=4, stage_axis="model")
    want = tokens
    for w in stacked:
        want = block(w, want)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    return {"leg": "pp", "mesh": list(mesh.shape), "shape": list(out.shape),
            "max_abs_err": float((out - want).abs().max())}


def _tp_llama(world: int):
    """(the unsharded Llama, its tensor-parallel copy over every rank); every
    sharded width scales with the world (``__graft_entry__.py:147-166``)."""
    from runia_core_tpu_torch.models import LlamaLM
    from runia_core_tpu_torch.parallel import make_mesh, shard_llama_params

    cfg = dict(vocab_size=8 * world, num_layers=2, num_heads=world, num_kv_heads=world, d_model=8 * world,
               hidden_dim=16 * world, max_len=32, device="cpu")
    dense = LlamaLM(**cfg).init_weights(torch.Generator().manual_seed(4))
    sharded = LlamaLM(**cfg)
    sharded.load_state_dict(dense.state_dict())
    return dense, shard_llama_params(sharded, make_mesh(world, model_parallel=world, device_type="cpu"))


def leg_tp(world: int) -> dict:
    """A tensor-parallel Llama forward (``__graft_entry__.py:147-170``)."""
    dense, sharded = _tp_llama(world)
    tokens = torch.zeros((2, 12), dtype=torch.int64)
    logits, want = sharded(tokens)[0], dense(tokens)[0]
    np.testing.assert_allclose(logits.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    return {"leg": "tp", "shape": list(logits.shape), "local_q_columns": int(sharded.block_0.q.kernel.shape[1]),
            "max_abs_err": float((logits - want).abs().max())}


def leg_engine(world: int) -> dict:
    """The serving engine over the tensor-parallel Llama
    (``__graft_entry__.py:172-191``)."""
    from runia_core_tpu_torch.llm import ContinuousBatchingEngine

    kw = dict(num_slots=2, max_ctx=32, max_new_tokens=4, chunk_tokens=4, prefill_chunk=8)
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8, 9]]
    dense, sharded = _tp_llama(world)
    served = ContinuousBatchingEngine(sharded, **kw).generate_all(prompts)
    want = ContinuousBatchingEngine(dense, **kw).generate_all(prompts)
    tokens = [r["tokens"] for r in served]
    if tokens != [r["tokens"] for r in want] or not all(len(t) == 4 for t in tokens):
        raise RuntimeError(f"tensor-parallel tokens {tokens} != {[r['tokens'] for r in want]}")
    if not all(np.isfinite(r["perplexity"]) for r in served):
        raise RuntimeError("non-finite perplexity")
    return {"leg": "engine", "tokens": tokens}


def leg_fsdp(world: int) -> dict:
    """One FSDP Adam step of the ``dp_tp`` ResNet (``__graft_entry__.py:193-216``)."""
    from torch.distributed.tensor import Shard

    from runia_core_tpu_torch.parallel import fsdp_train_step, make_mesh, shard_batch

    mesh = make_mesh(world, model_parallel=1, device_type="cpu")
    model = _resnet()
    step = fsdp_train_step(model, mesh, min_size=64)
    params = step.shard_params(dict(model.named_parameters()))
    opt = step.init_opt(params)
    images = torch.zeros((world * 2, 16, 16, 3))
    labels = torch.zeros((world * 2,), dtype=torch.int64)
    params, opt, loss = step(params, opt, shard_batch(images, mesh), shard_batch(labels, mesh))
    if not bool(torch.isfinite(loss)):
        raise RuntimeError(f"non-finite fsdp loss {float(loss)}")
    sharded = sum(any(isinstance(p, Shard) for p in leaf.placements) for leaf in params.values())
    if sharded == 0:
        raise RuntimeError("no parameter leaf was fsdp-sharded")
    return {"leg": "fsdp", "mesh": list(mesh.shape), "loss": float(loss), "sharded_leaves": sharded}


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
        return [globals()[f"leg_{leg}"](world) for leg in legs]
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
        parser.error(f"unknown legs {unknown}; the legs: {list(LEGS)}")
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
