"""Multi-process demo of the PyTorch port: a sharded LaREM fit and
data-parallel LaREx scoring (``runia_core_tpu_torch.parallel``).

The counterpart of ``demo_multichip.py``'s first two parts, on a
``torch.distributed`` world of two gloo processes on the CPU, from random
weights (no download):

    python examples/torch_demo_multichip.py

1. LaREM is fitted on a train set sharded over the ``data`` dimension
   (``fit_md_sharded``: one all-reduce of the moments, never the rows) and
   held to ``MDLatentSpace`` fitted on the whole set.
2. A LaREx scorer on a ``SimpleConvNet`` is split over the two processes
   (``data_parallel_scorer``); its scores equal the single-process scorer's
   for the same generator state.

The JAX demo's other parts (ring attention, expert and pipeline
parallelism, FSDP) use the model-parallel layer, which the port does not
have yet. On GPUs the same code runs one process per card with NCCL
(``initialize_distributed(..., device_type="cuda")``, ``make_mesh(n)``).
"""

import multiprocessing
import os
import sys
import tempfile

# Allow `python examples/<demo>.py` from a fresh checkout (the script dir,
# not the cwd, lands on sys.path).
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

WORLD = 2


def run(rank: int, init_method: str) -> None:
    import torch.distributed as dist

    from runia_core_tpu_torch.detectors import MDLatentSpace
    from runia_core_tpu_torch.detectors.latent import md_score
    from runia_core_tpu_torch.inference import build_larex_scorer
    from runia_core_tpu_torch.models import SimpleConvNet, build_tapped_forward
    from runia_core_tpu_torch.parallel import (
        data_parallel_scorer,
        fit_md_sharded,
        initialize_distributed,
        make_mesh,
        shard_batch,
    )

    torch.set_num_threads(1)
    initialize_distributed(init_method, WORLD, rank, device_type="cpu")
    try:
        mesh = make_mesh(WORLD, model_parallel=1, device_type="cpu")
        say = print if rank == 0 else (lambda *a: None)
        say(f"mesh: {tuple(mesh.shape)} ({mesh.mesh_dim_names}) over {WORLD} gloo processes")
        rng = np.random.RandomState(0)  # the same data on every rank

        # --- 1. Fit LaREM over a train set sharded across the data dimension ---
        train = torch.from_numpy(rng.randn(8192, 64).astype(np.float32))
        state = fit_md_sharded(shard_batch(train, mesh), mesh)
        md = MDLatentSpace()
        md.setup(train)
        test = torch.from_numpy(rng.randn(256, 64).astype(np.float32))
        diff = (md_score(test, state["feats_mean"], state["precision"]) - md.postprocess(test)).abs().max()
        say(f"sharded-fit precision {tuple(state['precision'].shape)}, fit parity (max abs diff): {float(diff):.2e}")

        # --- 2. Data-parallel LaREx scoring ---
        model = SimpleConvNet(num_classes=4, features=16, device="cpu")  # pre_pool has 32 channels
        model.init_weights(torch.Generator().manual_seed(0))
        md_entropy = MDLatentSpace()
        md_entropy.setup(torch.from_numpy(rng.randn(512, 32).astype(np.float32)))
        scorer = build_larex_scorer(build_tapped_forward(model), None, md_entropy.state, mcd_samples_nro=8,
                                    drop_block_prob=0.4, drop_block_size=3)
        images = torch.from_numpy(rng.rand(WORLD * 32, 32, 32, 3).astype(np.float32))
        _, single = scorer(images, torch.Generator().manual_seed(1))
        logits, scores = data_parallel_scorer(scorer, mesh)(images, torch.Generator().manual_seed(1))
        say(f"data-parallel LaREx over {WORLD} processes: batch {images.shape[0]}, logits "
            f"{tuple(logits.shape)}, max |dp - single| = {float((scores - single).abs().max()):.2e}")
    finally:
        dist.destroy_process_group()


def main() -> None:
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=run, args=(rank, f"file://{tmp}/rendezvous")) for rank in range(WORLD)]
        for proc in procs:
            proc.start()
        for proc in procs:
            proc.join(timeout=300)
            if proc.is_alive():
                proc.kill()
                proc.join()
    if any(proc.exitcode != 0 for proc in procs):
        raise SystemExit(f"a process failed: exit codes {[proc.exitcode for proc in procs]}")


if __name__ == "__main__":
    main()
