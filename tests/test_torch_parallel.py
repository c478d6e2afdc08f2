"""The port's data-parallel layer (``parallel/mesh.py``, ``parallel/sharded.py``,
``ops/knn.py::sharded_kth_neighbor``) against the JAX package's.

One gloo world of 4 CPU processes is spawned once for the module (``file://``
rendezvous, one thread each); every case runs in it on seeded numpy inputs
made here, and the processes send back their results. If they do not all
answer within ``DEADLINE_S`` they are killed and the tests fail. The JAX side
runs in this process on a 4-device mesh of the test session's virtual CPU
devices; this module imports JAX only inside its tests and fixtures, so the
spawned processes never load it. Tolerances are stated per case.
"""

import multiprocessing
import queue
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
WORLD = 4
DEADLINE_S = 180.0  # the whole world's, from the spawn (it takes about 25 s)
S, P, BS = 8, 0.4, 3  # the data-parallel scorer's MC samples, DropBlock probability and block size
LR = 0.1


def _inputs():
    rng = np.random.RandomState(0)
    f32 = np.float32
    return {
        "moments": rng.randn(800, 24).astype(f32),
        "md_fit": rng.randn(800, 16).astype(f32), "md_test": rng.randn(64, 16).astype(f32),
        "pca_fit": rng.randn(256, 12).astype(f32), "pca_test": rng.randn(20, 12).astype(f32),
        "kde_train": rng.randn(512, 16).astype(f32), "kde_test": rng.randn(32, 16).astype(f32),
        "knn_train": rng.randn(512, 8).astype(f32), "knn_test": rng.randn(32, 8).astype(f32),
        "dp_images": rng.rand(16, 16, 16, 1).astype(f32), "dp_md_fit": rng.randn(100, 16).astype(f32),
        "train_images": rng.rand(8, 16, 16, 3).astype(f32), "train_labels": rng.randint(0, 8, 8),
    }


def _cases(rank, data):
    """Every case, run by each rank of the world: {case: results (numpy)}."""
    import torch.distributed as dist

    from runia_core_tpu_torch.detectors import MDLatentSpace
    from runia_core_tpu_torch.detectors.latent import md_score
    from runia_core_tpu_torch.inference import build_larex_scorer
    from runia_core_tpu_torch.models import ResNet, SimpleConvNet, build_tapped_forward, resnet_from_flax
    from runia_core_tpu_torch.models.resnet import ResNetBlock
    from runia_core_tpu_torch.ops.knn import sharded_kth_neighbor
    from runia_core_tpu_torch.parallel import (
        data_parallel_scorer,
        fit_md_sharded,
        fit_pca_sharded,
        make_mesh,
        replicate,
        shard_batch,
        sharded_kde_log_density,
        sharded_knn_score,
        sharded_mean_and_covariance,
        sharded_train_step,
    )
    from runia_core_tpu_torch.reduction import pca_transform

    t = {name: torch.from_numpy(np.asarray(value)) for name, value in data.items() if isinstance(value, np.ndarray)}
    mesh = make_mesh(WORLD, model_parallel=1, device_type="cpu")

    def mine(x):
        return torch.chunk(x, WORLD)[rank]

    def moments():
        mean, cov = sharded_mean_and_covariance(shard_batch(t["moments"], mesh), mesh)
        return {"mean": mean, "cov": cov}

    def md():
        state = fit_md_sharded(shard_batch(t["md_fit"], mesh), mesh)
        dense = MDLatentSpace()
        dense.setup(t["md_fit"])
        return {**state, "scores": md_score(t["md_test"], state["feats_mean"], state["precision"]),
                "dense_scores": dense.postprocess(t["md_test"])}

    def pca():
        state = fit_pca_sharded(t["pca_fit"], mesh, n_components=5)
        return {"mean": state.mean, "components": state.components, "explained_variance": state.explained_variance,
                "projected": pca_transform(state, t["pca_test"])}

    def kde():
        return {"log_density": sharded_kde_log_density(t["kde_test"], mine(t["kde_train"]), n_total=512)}

    def knn():
        shard = mine(t["knn_train"])
        return {"score": sharded_knn_score(t["knn_test"], shard, k=5),
                "kth": sharded_kth_neighbor(t["knn_test"], shard, 5)}

    def dp_scorer():
        cnn = SimpleConvNet(num_classes=2, features=8, in_channels=1, device="cpu")
        cnn.load_state_dict(resnet_from_flax(data["dp_variables"], device="cpu"))
        state = {name: torch.from_numpy(v) for name, v in data["dp_state"].items()}
        scorer = build_larex_scorer(build_tapped_forward(cnn), None, state, S, P, BS)
        _, single = scorer(t["dp_images"], torch.Generator().manual_seed(3))
        dp = data_parallel_scorer(scorer, mesh)
        logits, sharded = dp(t["dp_images"], torch.Generator().manual_seed(3))
        _, sharded_dtensor = dp(shard_batch(t["dp_images"], mesh), torch.Generator().manual_seed(3))
        _, with_jax_weights = scorer(t["dp_images"], weights=torch.from_numpy(data["dp_jax_weights"]))
        one_rank = data_parallel_scorer(scorer, make_mesh(WORLD, model_parallel=WORLD, device_type="cpu"))
        _, one_part = one_rank(t["dp_images"], torch.Generator().manual_seed(3))
        return {"single": single, "sharded": sharded, "sharded_dtensor": sharded_dtensor, "logits": logits,
                "with_jax_weights": with_jax_weights, "one_part": one_part}

    def train_step():
        mesh22 = make_mesh(WORLD, model_parallel=2, device_type="cpu")
        model = ResNet((1, 1), ResNetBlock, 8, num_filters=8, cifar_stem=True, device="cpu")
        model.load_state_dict(resnet_from_flax(data["train_variables"], device="cpu"))
        step = sharded_train_step(model, mesh22, learning_rate=LR)
        params = step.shard_params(dict(model.named_parameters()))
        local_head_rows = params["head.weight"].shape[0]
        new, loss = step(params, shard_batch(t["train_images"], mesh22), shard_batch(t["train_labels"], mesh22))
        rows = [torch.empty_like(new["head.weight"]) for _ in range(2)]
        dist.all_gather(rows, new["head.weight"].contiguous(), group=mesh22.get_group("model"))
        return {**new, "head.weight": torch.cat(rows), "loss": loss, "local_head_rows": local_head_rows}

    def placement():
        batch = shard_batch(t["md_test"], mesh)
        full = replicate({"x": t["md_test"]}, mesh)["x"]
        refused = []
        for call in (lambda: make_mesh(2 * WORLD, device_type="cpu"), lambda: make_mesh(WORLD, 3, device_type="cpu")):
            try:
                call()
            except ValueError as exc:
                refused.append(str(exc))
        return {"local_rows": batch.to_local(), "expected_rows": mine(t["md_test"]),
                "replicated": full.to_local(), "refused": refused, "global_shape": list(batch.shape)}

    def multichip_legs():
        sys.path.insert(0, str(REPO))
        import torch_multichip

        return {"records": [torch_multichip.leg_dp_tp(WORLD), torch_multichip.leg_larex(WORLD)]}

    out = {}
    for name, case in (("moments", moments), ("md", md), ("pca", pca), ("kde", kde), ("knn", knn),
                       ("dp_scorer", dp_scorer), ("train_step", train_step), ("placement", placement),
                       ("multichip_legs", multichip_legs)):
        try:
            result = case()
            out[name] = {k: v.detach().numpy() if isinstance(v, torch.Tensor) else v for k, v in result.items()}
        except Exception:  # reported per case; the world carries on with the next
            out[name] = {"error": traceback.format_exc()}
    return out


def _worker(rank, init_method, data, results):
    """One process of the world: join, run every case, report, leave."""
    import torch.distributed as dist

    from runia_core_tpu_torch.parallel import initialize_distributed

    torch.set_num_threads(1)
    try:
        world = initialize_distributed(init_method, WORLD, rank, device_type="cpu")
        try:
            results.put((rank, {"world": world, **_cases(rank, data)}))
        finally:
            dist.destroy_process_group()
    except Exception:
        results.put((rank, {"fatal": traceback.format_exc()}))


def _jax_variables(model, shape, rng):
    """Seeded random variables of a flax model (numpy), shaped by
    ``jax.eval_shape`` (no eager init)."""
    import jax
    import jax.numpy as jnp

    shapes = jax.eval_shape(model.init, jax.random.key(0), jnp.zeros(shape))

    def fill(tree):
        return {k: fill(v) if isinstance(v, dict) else
                (rng.uniform(0.5, 1.5, v.shape) if k in ("scale", "var") else 0.3 * rng.randn(*v.shape))
                .astype(np.float32) for k, v in tree.items()}

    return {name: fill(shapes[name]) for name in shapes}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The inputs, the JAX models' variables, and every rank's results."""
    import jax

    from runia_core_tpu.detectors import MDLatentSpace as JaxMD
    from runia_core_tpu.models import ResNet as JaxResNet
    from runia_core_tpu.models import SimpleConvNet as JaxSimpleConvNet
    from runia_core_tpu.models.resnet import ResNetBlock as JaxResNetBlock
    from runia_core_tpu.ops.mc_entropy_pallas import mc_dropblock_weights as jax_mc_weights

    data = _inputs()
    rng = np.random.RandomState(1)
    models = {
        "dp": JaxSimpleConvNet(num_classes=2, features=8),
        "train": JaxResNet(stage_sizes=(1, 1), block_cls=JaxResNetBlock, num_classes=8, num_filters=8,
                           cifar_stem=True),
    }
    data["dp_variables"] = _jax_variables(models["dp"], (1, 16, 16, 1), rng)
    data["train_variables"] = _jax_variables(models["train"], (1, 16, 16, 3), rng)
    md = JaxMD()
    md.setup(data["dp_md_fit"])
    data["dp_state"] = {name: np.asarray(v) for name, v in md.state.items()}
    data["dp_jax_weights"] = np.asarray(jax_mc_weights(jax.random.key(3), 16, 4, 4, S, BS, P))

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    init_method = f"file://{tmp_path_factory.mktemp('gloo') / 'rendezvous'}"
    procs = [ctx.Process(target=_worker, args=(rank, init_method, data, results), daemon=True)
             for rank in range(WORLD)]
    for proc in procs:
        proc.start()
    reports, deadline = {}, time.monotonic() + DEADLINE_S
    try:
        while len(reports) < WORLD:  # drain the queue before joining
            rank, report = results.get(timeout=max(deadline - time.monotonic(), 0.1))
            reports[rank] = report
    except queue.Empty:
        pass
    finally:
        for proc in procs:
            proc.join(timeout=10)
            if proc.is_alive():
                proc.kill()
                proc.join()
    if len(reports) < WORLD:
        pytest.fail(f"the gloo world answered for ranks {sorted(reports)} of {WORLD} within {DEADLINE_S} s")
    fatal = {rank: r["fatal"] for rank, r in reports.items() if "fatal" in r}
    assert not fatal, fatal
    return data, models, reports


def _case(world, name):
    """Rank 0's results of a case, after checking no rank failed it."""
    reports = world[2]
    errors = {rank: r[name]["error"] for rank, r in reports.items() if "error" in r[name]}
    assert not errors, errors
    return reports[0][name]


def _jax_mesh():
    from runia_core_tpu.parallel import make_mesh

    return make_mesh(WORLD, model_parallel=1)


def test_the_world_has_four_ranks(world):
    assert [world[2][rank]["world"] for rank in range(WORLD)] == [WORLD] * WORLD


def test_mean_and_covariance_equal_jaxs(world):
    """One all_reduce of partial sums; to 1e-5 of JAX's shard_map psum (sums
    in other orders)."""
    import jax.numpy as jnp

    from runia_core_tpu.parallel import shard_batch
    from runia_core_tpu.parallel.sharded import sharded_mean_and_covariance

    got = _case(world, "moments")
    mesh = _jax_mesh()
    mean, cov = sharded_mean_and_covariance(shard_batch(jnp.asarray(world[0]["moments"]), mesh), mesh)
    np.testing.assert_allclose(got["mean"], np.asarray(mean), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["cov"], np.asarray(cov), rtol=0, atol=1e-5)
    for rank in range(1, WORLD):
        np.testing.assert_array_equal(world[2][rank]["moments"]["cov"], got["cov"])


def test_fit_md_sharded_equals_jaxs_and_the_dense_detector(world):
    """The state to JAX's sharded fit (mean 1e-5, precision 1e-3 of its
    largest entry: a pseudo-inverse); the scores to the port's
    ``MDLatentSpace`` fitted on the whole set (the JAX test's 1e-2)."""
    import jax.numpy as jnp

    from runia_core_tpu.parallel import shard_batch
    from runia_core_tpu.parallel.sharded import fit_md_sharded

    got = _case(world, "md")
    mesh = _jax_mesh()
    state = fit_md_sharded(shard_batch(jnp.asarray(world[0]["md_fit"]), mesh), mesh)
    np.testing.assert_allclose(got["feats_mean"], np.asarray(state["feats_mean"]), rtol=0, atol=1e-5)
    precision = np.asarray(state["precision"])
    np.testing.assert_allclose(got["precision"], precision, rtol=0, atol=1e-3 * np.abs(precision).max())
    np.testing.assert_allclose(got["scores"], got["dense_scores"], rtol=1e-2, atol=1e-2)


def test_fit_pca_sharded_equals_jaxs(world):
    """Eigenvectors of the all-reduced covariance, svd_flip signs: mean
    1e-5, explained variance 1e-4 relative, components and projections 1e-3
    (eigh in two libraries)."""
    import jax.numpy as jnp

    from runia_core_tpu.parallel.sharded import fit_pca_sharded
    from runia_core_tpu.reduction import pca_transform

    got = _case(world, "pca")
    state = fit_pca_sharded(jnp.asarray(world[0]["pca_fit"]), _jax_mesh(), n_components=5)
    np.testing.assert_allclose(got["mean"], np.asarray(state.mean), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["explained_variance"], np.asarray(state.explained_variance), rtol=1e-4)
    np.testing.assert_allclose(got["components"], np.asarray(state.components), rtol=0, atol=1e-3)
    want = np.asarray(pca_transform(state, jnp.asarray(world[0]["pca_test"])))
    np.testing.assert_allclose(got["projected"], want, rtol=0, atol=1e-3 * np.abs(want).max())


def _jax_shard_map(fn):
    from functools import partial

    from jax import shard_map
    from jax.sharding import PartitionSpec as Spec

    return partial(shard_map, mesh=_jax_mesh(), in_specs=(Spec(None, None), Spec("data", None)),
                   out_specs=Spec(None), check_vma=False)(fn)


def test_sharded_kde_equals_jaxs_and_the_dense_density(world):
    """A global max, then the shifted sums: to 1e-5 of JAX's sharded density
    and of the port's dense ``kde_log_density``."""
    import jax.numpy as jnp

    from runia_core_tpu.parallel.sharded import sharded_kde_log_density
    from runia_core_tpu_torch.detectors.latent import kde_log_density

    got = _case(world, "kde")["log_density"]
    data = world[0]
    theirs = _jax_shard_map(lambda t, tr: sharded_kde_log_density(t, tr, n_total=512))(
        jnp.asarray(data["kde_test"]), jnp.asarray(data["kde_train"]))
    np.testing.assert_allclose(got, np.asarray(theirs), rtol=1e-5, atol=1e-5)
    dense = kde_log_density(torch.from_numpy(data["kde_test"]), torch.from_numpy(data["kde_train"])).numpy()
    np.testing.assert_allclose(got, dense, rtol=1e-5, atol=1e-5)


def test_sharded_knn_and_kth_neighbor_equal_jaxs_and_the_dense_search(world):
    """Local top-k, all-gather, merge: the k-th distance equals the dense
    search's; JAX's within 1e-5 (distances by a matmul in each library)."""
    import jax.numpy as jnp

    from runia_core_tpu.ops.knn import sharded_kth_neighbor as jax_kth
    from runia_core_tpu.parallel.sharded import sharded_knn_score
    from runia_core_tpu_torch.ops.knn import squared_l2_kth_neighbor

    got = _case(world, "knn")
    data = world[0]
    test, train = jnp.asarray(data["knn_test"]), jnp.asarray(data["knn_train"])
    np.testing.assert_allclose(got["score"], np.asarray(_jax_shard_map(lambda t, tr: sharded_knn_score(t, tr, 5))(
        test, train)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["kth"], np.asarray(_jax_shard_map(lambda t, tr: jax_kth(t, tr, 5, "data"))(
        test, train)), rtol=1e-5, atol=1e-5)
    dense = squared_l2_kth_neighbor(torch.from_numpy(data["knn_test"]), torch.from_numpy(data["knn_train"]), 5)
    np.testing.assert_array_equal(got["kth"], dense.numpy())
    np.testing.assert_array_equal(got["score"], -got["kth"])


def test_the_data_parallel_scorer_equals_the_single_process_and_jaxs(world):
    """Split over 4 ranks, the scores equal the single-process scorer's for
    the same generator state (1e-5: per-row work on 4 rows against 16), on
    every rank, from a whole batch or a sharded one; the single-process
    scorer with the JAX keep-weights equals JAX's data-parallel scorer
    (1e-4 of max(|score|, 1))."""
    import jax
    import jax.numpy as jnp

    from runia_core_tpu.inference import build_larex_scorer as jax_build_larex_scorer
    from runia_core_tpu.models import build_tapped_forward as jax_tapped_forward
    from runia_core_tpu.parallel import data_parallel_scorer as jax_dp

    got = _case(world, "dp_scorer")
    data, models = world[0], world[1]
    np.testing.assert_allclose(got["sharded"], got["single"], rtol=1e-5, atol=1e-5)
    for rank in range(WORLD):
        np.testing.assert_array_equal(world[2][rank]["dp_scorer"]["sharded"], got["sharded"])
        np.testing.assert_array_equal(world[2][rank]["dp_scorer"]["sharded_dtensor"], got["sharded"])
    assert got["logits"].shape == (16, 2)
    scorer = jax_build_larex_scorer(jax_tapped_forward(models["dp"], data["dp_variables"]), pca_state=None,
                                    detector_state=data["dp_state"], mcd_samples_nro=S, drop_block_prob=P,
                                    drop_block_size=BS)
    _, theirs = jax_dp(scorer, _jax_mesh())(jnp.asarray(data["dp_images"]), jax.random.key(3))
    theirs = np.asarray(theirs)
    np.testing.assert_allclose(got["with_jax_weights"], theirs, rtol=0, atol=1e-4 * max(np.abs(theirs).max(), 1))


def test_a_data_dimension_of_one_rank_runs_the_split_path(world):
    """On a (1, 4) mesh the data dimension has one rank: the keep-weights
    drawn outside the scorer and its one-part all-gather give the
    single-process scorer's scores, bit for bit."""
    got = _case(world, "dp_scorer")
    for rank in range(WORLD):
        np.testing.assert_array_equal(world[2][rank]["dp_scorer"]["one_part"], got["single"])


def test_one_sharded_train_step_equals_jaxs(world):
    """One SGD step on a (2, 2) mesh (batch over data, head rows over
    model) against JAX's on its (2, 2) mesh, the same variables carried
    across: loss to 1e-5 relative; each parameter's update (the gradient
    times the rate) to 1e-4 of its largest entry."""
    import jax.numpy as jnp

    from runia_core_tpu.parallel import make_mesh, shard_batch, sharded_train_step
    from runia_core_tpu_torch.models import resnet_from_flax

    got = _case(world, "train_step")
    data, models = world[0], world[1]
    variables = data["train_variables"]
    mesh = make_mesh(WORLD, model_parallel=2)
    step = sharded_train_step(models["train"], mesh, learning_rate=LR,
                              extra_variables={"batch_stats": variables["batch_stats"]})
    params, loss = step(step.shard_params(variables["params"]), shard_batch(jnp.asarray(data["train_images"]), mesh),
                        jnp.asarray(data["train_labels"], jnp.int32))
    assert got["local_head_rows"] == 4
    np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
    before = resnet_from_flax(variables, device="cpu")
    after = resnet_from_flax({"params": _to_numpy(params)}, device="cpu")
    for name, new in after.items():
        want = (new - before[name]).numpy()
        np.testing.assert_allclose(got[name] - before[name].numpy(), want, rtol=0,
                                   atol=1e-4 * max(np.abs(want).max(), 1e-6), err_msg=name)
    assert np.abs(got["head.weight"] - before["head.weight"].numpy()).max() > 1e-3  # the step moved the head


def _to_numpy(tree):
    return {k: _to_numpy(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


def test_batches_shard_and_replicate_over_the_mesh(world):
    got = _case(world, "placement")
    for rank in range(WORLD):
        mine = world[2][rank]["placement"]
        np.testing.assert_array_equal(mine["local_rows"], mine["expected_rows"])
        np.testing.assert_array_equal(mine["replicated"], world[0]["md_test"])
    assert got["global_shape"] == [64, 16]
    assert got["refused"] == [f"need {2 * WORLD} devices, the world has {WORLD}",
                              f"{WORLD} devices not divisible by model_parallel=3"]


def test_the_multichip_dry_run_legs_pass(world):
    records = _case(world, "multichip_legs")["records"]
    assert [r["leg"] for r in records] == ["dp_tp", "larex"]
    assert records[0]["mesh"] == [2, 2] and np.isfinite(records[0]["loss"])
    assert records[1]["scores_max_abs_err"] <= 1e-4


def test_without_a_world_there_is_no_mesh():
    from runia_core_tpu_torch.parallel import initialize_distributed, make_mesh

    assert initialize_distributed() == 1 and initialize_distributed(num_processes=1) == 1
    with pytest.raises(RuntimeError, match="needs a torch.distributed world"):
        make_mesh(1, device_type="cpu")
