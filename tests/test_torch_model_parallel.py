"""The port's model-parallel layer (``parallel/{llama_tp,moe,ring_attention,
pipeline,fsdp}.py``) against the JAX package's.

One gloo world of 4 CPU processes is spawned once for the module
(``file://`` rendezvous, one thread each); every case runs in it on seeded
numpy inputs made here (the JAX Llamas' parameters carried across with
``llama_from_flax``), and the processes send back their results. If they do
not all answer within ``DEADLINE_S`` they are killed and the tests fail. The
JAX side runs in this process on meshes of the test session's virtual CPU
devices, the same shapes as the port's; JAX is imported only inside the
tests and fixtures, so the spawned processes never load it. The port keeps
a head whole on a rank, so the JAX tests' 4 / 2-head Llamas run on a model
axis of 2 (a (2, 2) mesh). Tolerances are stated per case.
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
DEADLINE_S = 150.0  # the whole world's, from the spawn (it takes about 30 s)
LLAMA = dict(vocab_size=64, num_layers=2, num_heads=4, num_kv_heads=2, d_model=32, hidden_dim=64, max_len=32)
# The tests/test_llama.py TP models, the int8 forms and a tied head.
VARIANTS = {
    "plain": {}, "attn_bias": {"attn_bias": True}, "mixtral": {"num_experts": 4},
    "int8_fused": {"quantized": True, "fused_qkv": True}, "mixtral_int8": {"num_experts": 4, "quantized": True},
    "tied": {"tie_embeddings": True},
}
# tests/test_continuous_batching.py's engine model and its TP case's engine.
ENGINE_LLAMA = dict(LLAMA, max_len=128)
ENGINE_KW = dict(num_slots=2, max_ctx=64, max_new_tokens=10, chunk_tokens=4, prefill_chunk=8)
RING = (2, 3, 64, 16)  # tests/test_ring_attention.py: B, H, L, D
PIPE_DIM, PIPE_BATCH = 8, 16
MOE = dict(T=64, D=16, H=32, E=8)  # tests/test_moe.py
FSDP_LR = 1e-2


def _llama_params(cfg, rng, tokens):
    """Seeded random parameters of a JAX LlamaLM (numpy), shaped by
    ``jax.eval_shape``: kernels and expert stacks N(0, 1/fan_in), the
    embedding N(0, 1), norm scales in [0.5, 1.5], biases 0.1 N(0, 1); an
    int8 model is the float one quantized by JAX (and fused)."""
    import jax

    from runia_core_tpu.models import LlamaLM as JaxLlamaLM
    from runia_core_tpu.models.llama import fuse_quantized_llama_params, quantize_llama_params

    float_cfg = {k: v for k, v in cfg.items() if k not in ("quantized", "fused_qkv", "quantized_kv")}
    shapes = jax.eval_shape(JaxLlamaLM(**float_cfg).init, jax.random.key(0), tokens)

    def leaf(name, shape):
        if name == "scale":
            return rng.uniform(0.5, 1.5, shape)
        if name == "bias":
            return 0.1 * rng.randn(*shape)
        if name == "embedding":
            return rng.randn(*shape)
        return rng.randn(*shape) / np.sqrt(shape[-2])

    def fill(tree):
        return {k: fill(v) if isinstance(v, dict) else leaf(k, v.shape).astype(np.float32) for k, v in tree.items()}

    params = {"params": fill(shapes["params"])}
    if cfg.get("quantized"):
        params = quantize_llama_params(params)
        if cfg.get("fused_qkv"):
            params = fuse_quantized_llama_params(params)
    return jax.tree_util.tree_map(np.asarray, params)


def _conv_variables(model, shape, rng):
    """Seeded random variables of a flax conv net (numpy), shaped by
    ``jax.eval_shape``."""
    import jax
    import jax.numpy as jnp

    shapes = jax.eval_shape(model.init, jax.random.key(0), jnp.zeros(shape))

    def fill(tree):
        return {k: fill(v) if isinstance(v, dict) else (0.3 * rng.randn(*v.shape)).astype(np.float32)
                for k, v in tree.items()}

    return {name: fill(shapes[name]) for name in shapes}


def _inputs(tmp_dir):
    from runia_core_tpu.models import SimpleConvNet as JaxSimpleConvNet

    rng = np.random.RandomState(0)
    f32 = np.float32
    data = {"tmp": str(tmp_dir)}
    data["tp_tokens"] = rng.randint(0, LLAMA["vocab_size"], (2, 9))
    data["llama"] = {name: _llama_params(dict(LLAMA, **kw), rng, data["tp_tokens"]) for name, kw in VARIANTS.items()}
    data["engine_llama"] = _llama_params(ENGINE_LLAMA, rng, data["tp_tokens"])
    data["engine_int8"] = _llama_params(dict(ENGINE_LLAMA, quantized=True, fused_qkv=True), rng, data["tp_tokens"])
    prng = np.random.RandomState(3)  # the engine test's prompts
    data["prompts"] = [list(prng.randint(1, LLAMA["vocab_size"], prng.randint(3, 20))) for _ in range(4)]
    r11 = np.random.RandomState(11)
    data["ring_qkv"] = [r11.randn(*RING).astype(f32) for _ in range(3)]
    data["ring_x"] = rng.randn(2, RING[2], 24).astype(f32)
    data["ring_w"] = [(rng.randn(24, 24) / np.sqrt(24)).astype(f32) for _ in range(4)]
    data["pipe_x"] = rng.randn(PIPE_BATCH, PIPE_DIM).astype(f32)
    data["pipe_blocks"] = {s: ((0.3 * rng.randn(s, PIPE_DIM, PIPE_DIM)).astype(f32),
                               (0.1 * rng.randn(s, PIPE_DIM)).astype(f32)) for s in (2, 4)}
    t, d, h, e = MOE["T"], MOE["D"], MOE["H"], MOE["E"]
    data["moe"] = ((rng.randn(d, e) / np.sqrt(d)).astype(f32), (rng.randn(e, d, h) / np.sqrt(d)).astype(f32),
                   (rng.randn(e, h, d) / np.sqrt(h)).astype(f32))
    data["moe_x"] = rng.randn(t, d).astype(f32)
    data["fsdp_images"] = rng.rand(16, 16, 16, 1).astype(f32)
    data["fsdp_labels"] = rng.randint(0, 4, 16)
    data["fsdp_variables"] = _conv_variables(JaxSimpleConvNet(num_classes=4, features=32), (1, 16, 16, 1), rng)
    data["fsdp_small_variables"] = _conv_variables(JaxSimpleConvNet(num_classes=3, features=16), (1, 16, 16, 1), rng)
    data["fsdp_small_labels"] = rng.randint(0, 3, 8)
    data["lm_tokens"] = rng.randint(1, LLAMA["vocab_size"], (16, 12))
    return data


def _cases(rank, data):
    """Every case, run by each rank of the world: {case: results (numpy)}."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from runia_core_tpu_torch.checkpoint import load_state_dict_orbax, save_state_dict_orbax
    from runia_core_tpu_torch.llm import ContinuousBatchingEngine
    from runia_core_tpu_torch.models import LlamaLM, SimpleConvNet, llama_from_flax, resnet_from_flax
    from runia_core_tpu_torch.parallel import (
        MoEParams,
        fsdp_train_step,
        make_mesh,
        moe_ffn,
        pipeline_apply,
        ring_attention,
        ring_self_attention,
        shard_batch,
        shard_llama_params,
        sharded_moe_ffn,
    )

    mesh22 = make_mesh(WORLD, model_parallel=2, device_type="cpu")
    tokens = torch.from_numpy(data["tp_tokens"])

    def llama(cfg, params):
        model = LlamaLM(**cfg, device="cpu")
        model.load_state_dict(llama_from_flax(params, device="cpu"))
        return model

    def summed(grads):
        """Each rank's gradient share, summed over the world."""
        out = []
        for g in grads:
            g = g.detach().clone()
            dist.all_reduce(g)
            out.append(g)
        return out

    def tp_forward():
        out = {}
        for name, kw in VARIANTS.items():
            model = llama(dict(LLAMA, **kw), data["llama"][name])
            want = model(tokens)
            shard_llama_params(model, mesh22)
            got = model(tokens)
            for i, what in enumerate(("logits", "attentions", "hiddens")):
                out[f"{name}/{what}"], out[f"{name}/unsharded_{what}"] = got[i], want[i]
            out[f"{name}/q_columns"] = (model.block_0.qkv.kernel_q if kw.get("fused_qkv") else
                                        model.block_0.q.kernel_q if kw.get("quantized") else
                                        model.block_0.q.kernel).shape[1]
        return out

    def tp_engine():
        out = {}
        for name, params, kw in (("f32", data["engine_llama"], {}),
                                 ("int8_kv8", data["engine_int8"], dict(quantized=True, quantized_kv=True,
                                                                        fused_qkv=True))):
            model = llama(dict(ENGINE_LLAMA, **kw), params)
            want = ContinuousBatchingEngine(model, **ENGINE_KW).generate_all(data["prompts"])
            shard_llama_params(model, mesh22)
            got = ContinuousBatchingEngine(model, **ENGINE_KW, collect_rauq=True).generate_all(data["prompts"])
            out[f"{name}/tokens"] = [r["tokens"] for r in got]
            out[f"{name}/unsharded_tokens"] = [r["tokens"] for r in want]
            out[f"{name}/log_probs"] = np.concatenate([r["log_probs"] for r in got])
            out[f"{name}/unsharded_log_probs"] = np.concatenate([r["log_probs"] for r in want])
            out[f"{name}/rauq_finite"] = all(np.isfinite(r["rauq"]).all() for r in got)
        return out

    def ring():
        out = {}
        seq4 = make_mesh(WORLD, axis_names=("seq", "unused"), device_type="cpu")
        for causal in (True, False):
            q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in data["ring_qkv"])
            o = ring_attention(q, k, v, seq4, seq_axis="seq", causal=causal)
            out[f"causal={causal}"] = o.full_tensor().detach()
            grads = summed(torch.autograd.grad((o.to_local() ** 2).sum(), (q, k, v)))
            out.update({f"causal={causal}/d{n}": g for n, g in zip("qkv", grads)})
        q, k, v = (torch.from_numpy(a) for a in data["ring_qkv"])
        seq_sharded = [distribute_tensor(t, seq4, [Shard(2), Replicate()]) for t in (q, k, v)]
        out["dtensor_in"] = ring_attention(*seq_sharded, seq4, seq_axis="seq").full_tensor()
        out["ring_of_two"] = ring_attention(q, k, v, mesh22, seq_axis="data").full_tensor()
        out["ring_of_two_local"] = ring_attention(q, k, v, mesh22, seq_axis="data").to_local()
        w = [torch.from_numpy(a) for a in data["ring_w"]]
        out["self_attention"] = ring_self_attention(torch.from_numpy(data["ring_x"]), *w, mesh=seq4, num_heads=3,
                                                    seq_axis="seq").full_tensor()
        return out

    def block_fn(params, x):
        w, b = params
        return x + torch.tanh(x @ w + b)

    def pipeline():
        out = {}
        x = torch.from_numpy(data["pipe_x"])
        for stages, micro in ((4, 4), (4, 8), (2, 2)):
            mesh = make_mesh(WORLD, model_parallel=stages, device_type="cpu")
            stacked = tuple(torch.from_numpy(a) for a in data["pipe_blocks"][stages])
            out[f"{stages}x{micro}"] = pipeline_apply(block_fn, stacked, x, mesh, micro)
        mesh = make_mesh(WORLD, model_parallel=4, device_type="cpu")
        stacked = tuple(torch.from_numpy(a).requires_grad_(True) for a in data["pipe_blocks"][4])
        xg = x.clone().requires_grad_(True)
        y = pipeline_apply(block_fn, stacked, xg, mesh, 4)
        out["dw"], out["db"], out["dx"] = summed(torch.autograd.grad((y ** 2).sum(), (*stacked, xg)))
        try:
            pipeline_apply(block_fn, stacked, x, mesh, 3)
            out["refused"] = ""
        except AssertionError as exc:
            out["refused"] = str(exc)
        return out

    def moe():
        out = {}
        params = MoEParams(*(torch.from_numpy(a) for a in data["moe"]))
        x = torch.from_numpy(data["moe_x"])
        e = MOE["E"]
        for top_k in (1, 2):
            out[f"sharded/top{top_k}"] = sharded_moe_ffn(params, x, mesh22, capacity_factor=float(e),
                                                         top_k=top_k).full_tensor()
            out[f"dense/top{top_k}"] = moe_ffn(params, x, capacity_factor=float(e), top_k=top_k)
        out["sharded/drops"] = sharded_moe_ffn(params, shard_batch(x, mesh22), mesh22, capacity_factor=0.125,
                                               top_k=1).full_tensor()
        out["dense/drops"] = moe_ffn(params, x, capacity_factor=0.125, top_k=1)
        grad_params = MoEParams(*(p.clone().requires_grad_(True) for p in params))
        y = sharded_moe_ffn(grad_params, x, mesh22, capacity_factor=float(e))
        out.update({f"grad/{n}": g for n, g in zip(MoEParams._fields, summed(torch.autograd.grad(
            (y.to_local() ** 2).sum(), grad_params)))})
        return out

    def conv(variables, classes, features):
        model = SimpleConvNet(num_classes=classes, features=features, in_channels=1, device="cpu")
        model.load_state_dict(resnet_from_flax(variables, device="cpu"))
        return model

    def fsdp():
        out = {}
        fmesh = make_mesh(WORLD, model_parallel=1, device_type="cpu")
        images, labels = torch.from_numpy(data["fsdp_images"]), torch.from_numpy(data["fsdp_labels"])
        model = conv(data["fsdp_variables"], 4, 32)
        step = fsdp_train_step(model, fmesh, learning_rate=FSDP_LR, min_size=256)
        ref_step = fsdp_train_step(model, fmesh, learning_rate=FSDP_LR)
        params = step.shard_params(dict(model.named_parameters()))
        opt = step.init_opt(params)
        ref_params = {n: p.detach().clone() for n, p in model.named_parameters()}
        ref_opt = ref_step.init_opt(ref_params)
        out["placements"] = {n: str(p.placements[0]) for n, p in params.items()}
        out["mu_placement"] = str(opt.mu["Conv_1.weight"].placements[0])
        out["local_conv1_rows"] = params["Conv_1.weight"].to_local().shape[0]
        losses, ref_losses = [], []
        for _ in range(3):
            params, opt, loss = step(params, opt, shard_batch(images, fmesh), shard_batch(labels, fmesh))
            ref_params, ref_opt, ref_loss = ref_step(ref_params, ref_opt, images, labels)
            losses.append(float(loss))
            ref_losses.append(float(ref_loss))
        out["losses"], out["ref_losses"] = losses, ref_losses
        out["params"] = {n: p.full_tensor() for n, p in params.items()}
        out["ref_params"] = ref_params
        out["still_sharded"] = str(params["Conv_1.weight"].placements[0])

        small = conv(data["fsdp_small_variables"], 3, 16)
        mse = fsdp_train_step(small, fmesh, min_size=256,
                              loss_fn=lambda o, targets: ((o[0] - targets) ** 2).mean())
        p = mse.shard_params(dict(small.named_parameters()))
        _, _, out["mse_loss"] = mse(p, mse.init_opt(p), shard_batch(images[:8], fmesh), torch.zeros((8, 3)))

        # Save mid-training, restore into the live layout, resume: equal to the run that went on.
        step = fsdp_train_step(small, fmesh, min_size=256)
        small_labels = torch.from_numpy(data["fsdp_small_labels"])
        p = step.shard_params(dict(small.named_parameters()))
        opt = step.init_opt(p)
        p, opt, _ = step(p, opt, images[:8], small_labels)
        path = Path(data["tmp"])
        save_state_dict_orbax(path / "params", p)
        save_state_dict_orbax(path / "mu", opt.mu)
        resumed_p = load_state_dict_orbax(path / "params", like=p)
        resumed_mu = load_state_dict_orbax(path / "mu", like=opt.mu)
        out["resumed_placement"] = str(resumed_p["Conv_1.weight"].placements[0])
        cont, _, _ = step(p, opt, images[:8], small_labels)
        res, _, _ = step(resumed_p, opt._replace(mu=resumed_mu), images[:8], small_labels)
        out["resume_err"] = max(float((cont[n].full_tensor() - res[n].full_tensor()).abs().max()) for n in cont)

        lm = llama(LLAMA, data["llama"]["plain"])
        lm_tokens = torch.from_numpy(data["lm_tokens"])
        lm_step = fsdp_train_step(lm, fmesh, task="causal_lm", min_size=512)
        p = lm_step.shard_params(dict(lm.named_parameters()))
        new, _, out["lm_loss"] = lm_step(p, lm_step.init_opt(p), shard_batch(lm_tokens, fmesh), lm_tokens)
        out["lm_embedding_placement"] = str(new["embed.embedding"].placements[0])
        out["lm_params_frozen"] = not any(q.requires_grad for q in lm.parameters())
        return out

    def refusals():
        out = {}
        for what, kw in (("num_heads", dict(num_heads=3, num_kv_heads=3, d_model=24)),
                         ("num_kv_heads", dict(num_kv_heads=1)), ("hidden_dim", dict(hidden_dim=65)),
                         ("vocab_size", dict(vocab_size=63))):
            try:
                shard_llama_params(LlamaLM(**dict(LLAMA, **kw), device="cpu"), mesh22)
                out[what] = ""
            except ValueError as exc:
                out[what] = str(exc)
        q = distribute_tensor(torch.from_numpy(data["ring_qkv"][0]), mesh22, [Replicate(), Replicate()])
        w = distribute_tensor(torch.from_numpy(data["pipe_blocks"][2][0]), mesh22, [Replicate(), Shard(1)])
        for what, call in (("ring", lambda: ring_attention(q, q, q, mesh22)),
                           ("pipeline", lambda: pipeline_apply(block_fn, (w, w), torch.zeros((4, PIPE_DIM)),
                                                               mesh22, 2))):
            try:
                call()
                out[what] = ""
            except ValueError as exc:
                out[what] = str(exc)
        return out

    def multichip_legs():
        sys.path.insert(0, str(REPO))
        import torch_multichip

        return {"records": [getattr(torch_multichip, f"leg_{leg}")(WORLD)
                            for leg in ("sp", "ep", "pp", "tp", "engine", "fsdp")]}

    def to_numpy(v):
        if isinstance(v, torch.Tensor):
            return v.detach().numpy()
        if isinstance(v, dict):
            return {k: to_numpy(x) for k, x in v.items()}
        return v

    out = {}
    for name, case in (("tp_forward", tp_forward), ("tp_engine", tp_engine), ("ring", ring),
                       ("pipeline", pipeline), ("moe", moe), ("fsdp", fsdp), ("refusals", refusals),
                       ("multichip_legs", multichip_legs)):
        try:
            out[name] = to_numpy(case())
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


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The inputs and every rank's results."""
    data = _inputs(tmp_path_factory.mktemp("fsdp_checkpoint"))
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
    return data, reports


def _case(world, name):
    """Rank 0's results of a case, after checking no rank failed it."""
    reports = world[1]
    errors = {rank: r[name]["error"] for rank, r in reports.items() if "error" in r[name]}
    assert not errors, errors
    return reports[0][name]


def _jax_mesh(shape, names):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape), names)


# ---- tensor parallelism (llama_tp.py) ----


def _jax_spec_names(specs):
    """{dotted flax path: PartitionSpec} of a JAX spec tree."""
    import jax

    flat = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {".".join(p.key for p in path[1:]): spec for path, spec in flat}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_llama_tp_specs_equal_jaxs_name_for_name(variant):
    """Every parameter's placement is JAX's spec for the flax path of the
    same name: ``Shard(d)`` where the spec names ``model`` on dim d,
    ``Replicate()`` where it is ``P()``; the fused int8 qkv / gateup stay
    replicated, o and down row-sharded."""
    import jax
    from torch.distributed.tensor import Replicate, Shard

    from runia_core_tpu.parallel import llama_tp_specs as jax_specs
    from runia_core_tpu_torch.models import LlamaLM, llama_from_flax
    from runia_core_tpu_torch.parallel import llama_tp_specs

    cfg = dict(LLAMA, **VARIANTS[variant])
    params = _llama_params(cfg, np.random.RandomState(1), np.zeros((1, 4), np.int32))
    theirs = _jax_spec_names(jax_specs(jax.tree_util.tree_map(np.asarray, params)))
    ours = llama_tp_specs(LlamaLM(**cfg, device="cpu"))
    assert sorted(ours) == sorted(theirs)
    assert llama_tp_specs(llama_from_flax(params, device="cpu")) == ours
    for name, spec in theirs.items():
        want = Replicate() if all(a is None for a in spec) else Shard(list(spec).index("model"))
        assert ours[name] == want, name
    if variant == "int8_fused":
        assert ours["block_0.qkv.kernel_q"] == Replicate() and ours["block_0.gateup.scale"] == Replicate()
        assert ours["block_0.o.kernel_q"] == Shard(0) and ours["block_0.down.kernel_q"] == Shard(0)


@pytest.fixture(scope="module")
def jax_tp_outputs(world):
    """JAX's TP forward of each variant on a 2-device model mesh (logits,
    attentions, hiddens, numpy)."""
    import jax
    import jax.numpy as jnp

    from runia_core_tpu.models import LlamaLM as JaxLlamaLM
    from runia_core_tpu.parallel import shard_llama_params as jax_shard

    data = world[0]
    mesh = _jax_mesh((2,), ("model",))
    out = {}
    for name, kw in VARIANTS.items():
        model = JaxLlamaLM(**dict(LLAMA, **kw))
        sharded = jax_shard(jax.tree_util.tree_map(jnp.asarray, data["llama"][name]), mesh)
        logits, attns, hiddens, _ = jax.jit(lambda p, t: model.apply(p, t))(sharded, jnp.asarray(data["tp_tokens"]))
        out[name] = {"logits": np.asarray(logits), "attentions": np.asarray(attns), "hiddens": np.asarray(hiddens)}
    return out


# f32 sums in other orders (atol); the int8 models add JAX's int8 matmul route.
TP_ATOL = {"plain": 1e-5, "attn_bias": 1e-5, "mixtral": 1e-5, "tied": 1e-5, "int8_fused": 1e-4,
           "mixtral_int8": 1e-4}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_tp_forward_equals_jaxs_and_the_unsharded_one(world, jax_tp_outputs, variant):
    """On a (2, 2) mesh (heads over model), logits, attentions (heads
    gathered) and hiddens equal JAX's TP forward on its 2-device model mesh
    (``TP_ATOL``) and the port's unsharded forward (1e-5), on every rank;
    each rank keeps half the q columns (the fused qkv all of them)."""
    got = _case(world, "tp_forward")
    for what in ("logits", "attentions", "hiddens"):
        want = jax_tp_outputs[variant][what]
        assert got[f"{variant}/{what}"].shape == want.shape, what
        np.testing.assert_allclose(got[f"{variant}/{what}"], want, rtol=0, atol=TP_ATOL[variant], err_msg=what)
        np.testing.assert_allclose(got[f"{variant}/{what}"], got[f"{variant}/unsharded_{what}"], rtol=0, atol=1e-5,
                                   err_msg=what)
        for rank in range(1, WORLD):
            np.testing.assert_array_equal(world[1][rank]["tp_forward"][f"{variant}/{what}"], got[f"{variant}/{what}"])
    nq = LLAMA["num_heads"] * LLAMA["d_model"] // LLAMA["num_heads"]
    full = nq + 2 * LLAMA["num_kv_heads"] * LLAMA["d_model"] // LLAMA["num_heads"]
    assert got[f"{variant}/q_columns"] == (full if variant == "int8_fused" else nq // 2)


def test_shard_llama_params_refuses_a_split_head(world):
    """Heads, KV heads, hidden and vocabulary must divide by the model axis
    (2): a ValueError names the dimension."""
    got = _case(world, "refusals")
    assert {k: v for k, v in got.items() if k not in ("ring", "pipeline")} == {
        what: f"{what}={n} does not divide by the model axis (2)"
        for what, n in (("num_heads", 3), ("num_kv_heads", 1), ("hidden_dim", 65), ("vocab_size", 63))}


def test_dtensor_inputs_placed_otherwise_are_refused(world):
    """A DTensor that ring attention or the pipeline would read as its shard
    must be sharded as they shard it; otherwise a ValueError, never a
    silent read of the wrong rows."""
    got = _case(world, "refusals")
    assert got["ring"] == "a DTensor input must be Shard(2) over data, not Replicate()"
    assert got["pipeline"] == "stacked DTensor parameters must be Shard(0) over model, not Shard(dim=1)"


@pytest.fixture(scope="module")
def jax_engine_tokens(world):
    """JAX's engine over TP-sharded params (2-device model mesh): greedy
    tokens per prompt, for the f32 and the int8 + KV8 + fused model."""
    import jax
    import jax.numpy as jnp

    from runia_core_tpu.llm import ContinuousBatchingEngine as JaxEngine
    from runia_core_tpu.models import LlamaLM as JaxLlamaLM
    from runia_core_tpu.parallel import shard_llama_params as jax_shard

    data = world[0]
    mesh = _jax_mesh((2,), ("model",))
    out = {}
    for name, params, kw in (("f32", data["engine_llama"], {}),
                             ("int8_kv8", data["engine_int8"], dict(quantized=True, quantized_kv=True,
                                                                    fused_qkv=True))):
        sharded = jax_shard(jax.tree_util.tree_map(jnp.asarray, params), mesh)
        eng = JaxEngine(JaxLlamaLM(**dict(ENGINE_LLAMA, **kw)), sharded, **ENGINE_KW)
        out[name] = [r["tokens"] for r in eng.generate_all(data["prompts"])]
    return out


@pytest.mark.parametrize("model", ["f32", "int8_kv8"])
def test_the_tp_engine_serves_jaxs_tokens(world, jax_engine_tokens, model):
    """``ContinuousBatchingEngine`` over a model made tensor-parallel
    (tests/test_continuous_batching.py:547-560): greedy tokens equal JAX's
    TP engine's and the unsharded port engine's, log-probs the unsharded
    engine's within 1e-5, RAUQ (attentions gathered) finite."""
    got = _case(world, "tp_engine")
    assert got[f"{model}/tokens"] == jax_engine_tokens[model]
    assert got[f"{model}/tokens"] == got[f"{model}/unsharded_tokens"]
    np.testing.assert_allclose(got[f"{model}/log_probs"], got[f"{model}/unsharded_log_probs"], rtol=0, atol=1e-5)
    assert got[f"{model}/rauq_finite"]


# ---- sequence parallelism (ring_attention.py) ----


def _jax_ring(causal, mesh=None, axis="seq"):
    import jax.numpy as jnp

    from runia_core_tpu.parallel import ring_attention as jax_ring

    def fn(q, k, v):
        return jax_ring(q, k, v, mesh if mesh is not None else _jax_mesh((WORLD, 1), ("seq", "unused")),
                        seq_axis=axis, causal=causal)

    return fn, jnp


@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_and_its_gradient_equal_jaxs(world, causal):
    """A ring of 4, K/V rotating by batch_isend_irecv: the output to 1e-5 of
    JAX's ring (tests/test_ring_attention.py's bound), and the gradient of
    sum(out^2) (each rank's share, summed) to 1e-4."""
    import jax

    got = _case(world, "ring")
    fn, jnp = _jax_ring(causal)
    q, k, v = (jnp.asarray(a) for a in world[0]["ring_qkv"])
    np.testing.assert_allclose(got[f"causal={causal}"], np.asarray(fn(q, k, v)), rtol=1e-5, atol=1e-5)
    grads = jax.grad(lambda a, b, c: (fn(a, b, c) ** 2).sum(), argnums=(0, 1, 2))(q, k, v)
    for name, want in zip("qkv", grads):
        np.testing.assert_allclose(got[f"causal={causal}/d{name}"], np.asarray(want), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def test_ring_attention_takes_sequence_sharded_dtensors_and_rings_of_two(world):
    """A DTensor sharded on the sequence dim gives what whole tensors give
    (bit for bit); a ring of 2 (the data dim of a (2, 2) mesh) gives JAX's
    2-device ring (1e-5), and each rank holds its half of the sequence."""
    got = _case(world, "ring")
    np.testing.assert_array_equal(got["dtensor_in"], got["causal=True"])
    fn, jnp = _jax_ring(True, _jax_mesh((2, 1), ("seq", "unused")))
    want = np.asarray(fn(*(jnp.asarray(a) for a in world[0]["ring_qkv"])))
    np.testing.assert_allclose(got["ring_of_two"], want, rtol=1e-5, atol=1e-5)
    for rank in range(WORLD):
        half = world[1][rank]["ring"]["ring_of_two_local"]
        lo = (rank // 2) * RING[2] // 2
        np.testing.assert_array_equal(half, got["ring_of_two"][:, :, lo:lo + RING[2] // 2])


def test_ring_self_attention_equals_jaxs(world):
    """The projections on each rank's positions, the core on the ring: to
    1e-4 of JAX's ``ring_self_attention`` (its test's bound)."""
    import jax.numpy as jnp

    from runia_core_tpu.parallel import ring_self_attention as jax_layer

    got = _case(world, "ring")
    data = world[0]
    want = jax_layer(jnp.asarray(data["ring_x"]), *(jnp.asarray(w) for w in data["ring_w"]),
                     mesh=_jax_mesh((WORLD, 1), ("seq", "unused")), num_heads=3, seq_axis="seq")
    np.testing.assert_allclose(got["self_attention"], np.asarray(want), rtol=1e-4, atol=1e-4)


# ---- pipeline parallelism (pipeline.py) ----


def _jax_block(params, x):
    import jax.numpy as jnp

    w, b = params
    return x + jnp.tanh(x @ w + b)


def _jax_pipeline(stages, micro, stacked, x):
    from runia_core_tpu.parallel import make_mesh as jax_make_mesh
    from runia_core_tpu.parallel import pipeline_apply as jax_pipeline

    return jax_pipeline(_jax_block, stacked, x, jax_make_mesh(stages, model_parallel=stages), micro)


@pytest.mark.parametrize("stages,micro", [(4, 4), (4, 8), (2, 2)])
def test_the_pipeline_equals_jaxs_and_the_sequential_blocks(world, stages, micro):
    """GPipe over ``stages`` ranks of the model axis, ``micro``
    microbatches: to 1e-5 of JAX's ``pipeline_apply`` and of the blocks
    applied in sequence (tests/test_pipeline.py's bound)."""
    import jax.numpy as jnp

    got = _case(world, "pipeline")[f"{stages}x{micro}"]
    data = world[0]
    w, b = data["pipe_blocks"][stages]
    x = data["pipe_x"]
    want = np.asarray(_jax_pipeline(stages, micro, (jnp.asarray(w), jnp.asarray(b)), jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    seq = torch.from_numpy(x)
    for s in range(stages):
        seq = seq + torch.tanh(seq @ torch.from_numpy(w[s]) + torch.from_numpy(b[s]))
    np.testing.assert_allclose(got, seq.numpy(), rtol=1e-5, atol=1e-6)


def test_the_pipeline_gradient_equals_jaxs(world):
    """The gradient of sum(out^2) through the hops' autograd Functions (each
    stage's share, summed) to 1e-4 of JAX's for the blocks and the input."""
    import jax
    import jax.numpy as jnp

    got = _case(world, "pipeline")
    data = world[0]
    stacked = tuple(jnp.asarray(a) for a in data["pipe_blocks"][4])
    x = jnp.asarray(data["pipe_x"])
    (dw, db), dx = jax.grad(lambda p, xx: (_jax_pipeline(4, 4, p, xx) ** 2).sum(), argnums=(0, 1))(stacked, x)
    for name, want in (("dw", dw), ("db", db), ("dx", dx)):
        np.testing.assert_allclose(got[name], np.asarray(want), rtol=1e-4, atol=1e-5, err_msg=name)


def test_the_pipeline_batch_must_divide(world):
    assert _case(world, "pipeline")["refused"] == "batch 16 not divisible by 3 microbatches"


# ---- expert parallelism (moe.py) ----


def _jax_moe(world):
    import jax.numpy as jnp

    from runia_core_tpu.parallel.moe import MoEParams as JaxMoEParams

    data = world[0]
    return JaxMoEParams(*(jnp.asarray(a) for a in data["moe"])), jnp.asarray(data["moe_x"])


@pytest.mark.parametrize("top_k", [1, 2])
def test_sharded_moe_equals_jaxs_and_the_unsharded_layer(world, top_k):
    """Tokens over data (2), experts over model (2), ample capacity: the
    sharded layer to 1e-5 of JAX's sharded layer on its (2, 2) mesh and of
    the unsharded layer; the unsharded layer to 1e-5 of JAX's."""
    from runia_core_tpu.parallel import make_mesh as jax_make_mesh
    from runia_core_tpu.parallel.moe import moe_ffn as jax_moe_ffn
    from runia_core_tpu.parallel.moe import sharded_moe_ffn as jax_sharded

    got = _case(world, "moe")
    params, x = _jax_moe(world)
    e = float(MOE["E"])
    want = np.asarray(jax_sharded(params, x, jax_make_mesh(WORLD, model_parallel=2), capacity_factor=e, top_k=top_k))
    np.testing.assert_allclose(got[f"sharded/top{top_k}"], want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[f"sharded/top{top_k}"], got[f"dense/top{top_k}"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[f"dense/top{top_k}"], np.asarray(jax_moe_ffn(params, x, e, top_k)), rtol=1e-5,
                               atol=1e-6)


def test_moe_capacity_drops_tokens_as_jax_does(world):
    """Capacity 1 a group (factor 0.125): the overflowing tokens give exact
    zeros, which tokens drop is decided per data shard as in JAX's grouped
    routing (to 1e-5 of JAX's sharded layer), and the unsharded layer drops
    as JAX's does."""
    from runia_core_tpu.parallel import make_mesh as jax_make_mesh
    from runia_core_tpu.parallel.moe import moe_ffn as jax_moe_ffn
    from runia_core_tpu.parallel.moe import sharded_moe_ffn as jax_sharded

    got = _case(world, "moe")
    params, x = _jax_moe(world)
    want = np.asarray(jax_sharded(params, x, jax_make_mesh(WORLD, model_parallel=2), capacity_factor=0.125))
    np.testing.assert_allclose(got["sharded/drops"], want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["dense/drops"], np.asarray(jax_moe_ffn(params, x, 0.125)), rtol=1e-5, atol=1e-6)
    zero_rows = np.abs(got["dense/drops"]).max(axis=1) == 0
    assert zero_rows.sum() >= MOE["T"] - MOE["E"]


def test_sharded_moe_gradients_equal_jaxs(world):
    """The gradient of sum(out^2) through the differentiable all-reduce
    (each rank's share, summed over the world) to JAX's (tests/test_moe.py's
    bound: 1e-4 relative, 5e-5 absolute); every expert gets one."""
    import jax

    from runia_core_tpu.parallel import make_mesh as jax_make_mesh
    from runia_core_tpu.parallel.moe import sharded_moe_ffn as jax_sharded

    got = _case(world, "moe")
    params, x = _jax_moe(world)
    mesh = jax_make_mesh(WORLD, model_parallel=2)
    grads = jax.grad(lambda p: (jax_sharded(p, x, mesh, capacity_factor=float(MOE["E"])) ** 2).sum())(params)
    for name, want in zip(grads._fields, grads):
        np.testing.assert_allclose(got[f"grad/{name}"], np.asarray(want), rtol=1e-4, atol=5e-5, err_msg=name)
    assert (np.abs(got["grad/w_in"]).reshape(MOE["E"], -1).max(axis=1) > 0).all()


def test_init_moe_draws_scaled_normal_weights():
    from runia_core_tpu_torch.parallel import init_moe

    params = init_moe(torch.Generator().manual_seed(0), 64, 128, 8)
    assert [tuple(p.shape) for p in params] == [(64, 8), (8, 64, 128), (8, 128, 64)]
    for p, fan_in in zip(params, (64, 64, 128)):
        assert abs(float(p.std()) * fan_in**0.5 - 1) < 0.1
    again = init_moe(torch.Generator().manual_seed(0), 64, 128, 8)
    assert all(torch.equal(a, b) for a, b in zip(params, again))


# ---- FSDP (fsdp.py) ----


@pytest.mark.parametrize("shape,n,min_size,want", [
    ((64,), 8, 2**14, None), ((48, 1024), 8, 1, 1), ((2048, 9), 8, 1, 0), ((9, 9), 8, 1, None),
    ((3, 3, 32, 64), 4, 256, 3), ((), 4, 1, None),
])
def test_fsdp_spec_follows_jaxs_rules(shape, n, min_size, want):
    """Small leaves replicated, the largest dim that divides sharded, an
    indivisible leaf replicated (tests/test_fsdp.py:35-43), as JAX's spec."""
    import jax.numpy as jnp
    from torch.distributed.tensor import Replicate, Shard

    from runia_core_tpu.parallel import fsdp_spec as jax_fsdp_spec
    from runia_core_tpu_torch.parallel import fsdp_spec

    ours = fsdp_spec(torch.zeros(shape), n, min_size)
    assert ours == (Replicate() if want is None else Shard(want))
    theirs = tuple(jax_fsdp_spec(jnp.zeros(shape), n, min_size))
    assert theirs == tuple("data" if i == want else None for i in range(len(theirs)))


@pytest.fixture(scope="module")
def jax_fsdp(world):
    """JAX's FSDP runs on its 4-device data mesh: three steps of the conv
    net (losses, parameters), the custom loss and the causal-LM loss."""
    import jax
    import jax.numpy as jnp

    from runia_core_tpu.models import LlamaLM as JaxLlamaLM
    from runia_core_tpu.models import SimpleConvNet as JaxSimpleConvNet
    from runia_core_tpu.parallel import fsdp_train_step as jax_step
    from runia_core_tpu.parallel import make_mesh as jax_make_mesh
    from runia_core_tpu.parallel import shard_batch as jax_shard_batch

    data = world[0]
    mesh = jax_make_mesh(WORLD, model_parallel=1)
    out = {}
    step = jax_step(JaxSimpleConvNet(num_classes=4, features=32), mesh, learning_rate=FSDP_LR, min_size=256)
    params = step.shard_params(jax.tree_util.tree_map(jnp.asarray, data["fsdp_variables"]["params"]))
    opt = step.init_opt(params)
    images, labels = jax_shard_batch(jnp.asarray(data["fsdp_images"]), mesh), jnp.asarray(data["fsdp_labels"])
    losses = []
    for _ in range(3):
        params, opt, loss = step(params, opt, images, labels)
        losses.append(float(loss))
    out["losses"], out["params"] = losses, jax.tree_util.tree_map(np.asarray, params)
    mse = jax_step(JaxSimpleConvNet(num_classes=3, features=16), mesh, min_size=256,
                   loss_fn=lambda o, targets: jnp.mean((o[0] - targets) ** 2))
    p = mse.shard_params(jax.tree_util.tree_map(jnp.asarray, data["fsdp_small_variables"]["params"]))
    _, _, loss = mse(p, mse.init_opt(p), jax_shard_batch(jnp.asarray(data["fsdp_images"][:8]), mesh),
                     jnp.zeros((8, 3)))
    out["mse_loss"] = float(loss)
    lm = jax_step(JaxLlamaLM(**LLAMA), mesh, task="causal_lm", min_size=512)
    p = lm.shard_params(jax.tree_util.tree_map(jnp.asarray, data["llama"]["plain"]["params"]))
    tokens = jax_shard_batch(jnp.asarray(data["lm_tokens"], jnp.int32), mesh)
    _, _, loss = lm(p, lm.init_opt(p), tokens, tokens)
    out["lm_loss"] = float(loss)
    return out


def test_fsdp_steps_equal_one_device_and_jaxs(world, jax_fsdp):
    """Three Adam steps with leaves of 256 elements and more sharded over
    data (4): the losses equal the replicated step's (1e-5 relative) and
    JAX's (1e-5 relative, tests/test_fsdp.py's bound), the parameters equal
    the replicated step's (1e-4 relative, 1e-5 absolute) and JAX's carried
    across (same bound); the big conv kernel and its moment stay sharded."""
    from runia_core_tpu_torch.models import resnet_from_flax

    got = _case(world, "fsdp")
    np.testing.assert_allclose(got["losses"], got["ref_losses"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["losses"], jax_fsdp["losses"], rtol=1e-5, atol=1e-6)
    for name, want in got["ref_params"].items():
        np.testing.assert_allclose(got["params"][name], want, rtol=1e-4, atol=1e-5, err_msg=name)
    theirs = resnet_from_flax({"params": jax_fsdp["params"]}, device="cpu")
    for name, want in theirs.items():
        np.testing.assert_allclose(got["params"][name], want.numpy(), rtol=1e-4, atol=1e-5, err_msg=name)
    assert got["placements"]["Conv_1.weight"] == "S(0)" and got["placements"]["Conv_0.bias"] == "R"
    assert got["mu_placement"] == got["still_sharded"] == "S(0)"
    assert got["local_conv1_rows"] == 64 // WORLD


def test_fsdp_takes_a_custom_loss_fn(world, jax_fsdp):
    """``loss_fn`` on each rank's rows, averaged over the data ranks: JAX's
    loss on the whole batch to 1e-5 relative."""
    np.testing.assert_allclose(float(_case(world, "fsdp")["mse_loss"]), jax_fsdp["mse_loss"], rtol=1e-5)


def test_fsdp_resumes_from_a_checkpoint(world):
    """Sharded parameters and moments saved by the port's
    ``save_state_dict_orbax`` and read back into the live layout resume the
    run exactly (1e-7), still sharded."""
    got = _case(world, "fsdp")
    assert got["resumed_placement"] == "S(0)"
    assert got["resume_err"] <= 1e-7


def test_fsdp_trains_a_causal_lm(world, jax_fsdp):
    """``task="causal_lm"`` through the Llama's differentiable forward (its
    parameters stay frozen): JAX's loss to 1e-5 relative, the embedding
    sharded."""
    got = _case(world, "fsdp")
    np.testing.assert_allclose(float(got["lm_loss"]), jax_fsdp["lm_loss"], rtol=1e-5)
    assert got["lm_embedding_placement"] == "S(0)"
    assert got["lm_params_frozen"]


def test_the_llama_inference_forward_builds_no_graph():
    """The forward callers use stays under ``no_grad`` even with grad-enabled
    parameters; the differentiable one builds a graph."""
    from runia_core_tpu_torch.models import LlamaLM

    model = LlamaLM(**LLAMA, device="cpu").init_weights(torch.Generator().manual_seed(0))
    for p in model.parameters():
        p.requires_grad_(True)
    tokens = torch.zeros((1, 4), dtype=torch.int64)
    assert not model(tokens)[0].requires_grad
    assert model.differentiable_forward(tokens, need_attentions=False, need_hiddens=False)[0].requires_grad


# ---- the dry run ----


def test_the_model_parallel_dry_run_legs_pass(world):
    """torch_multichip.py's six model-parallel legs in the world of 4."""
    records = _case(world, "multichip_legs")["records"]
    assert [r["leg"] for r in records] == ["sp", "ep", "pp", "tp", "engine", "fsdp"]
    assert records[0]["max_abs_err"] <= 1e-5 and records[2]["max_abs_err"] <= 1e-5
    assert records[3]["local_q_columns"] == 8 and records[3]["max_abs_err"] <= 1e-5
    assert all(len(t) == 4 for t in records[4]["tokens"])
    assert records[5]["sharded_leaves"] > 0 and np.isfinite(records[5]["loss"])


def test_the_world_has_four_ranks(world):
    assert [world[1][rank]["world"] for rank in range(WORLD)] == [WORLD] * WORLD
