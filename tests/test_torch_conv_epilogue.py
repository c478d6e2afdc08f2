"""The conv-norm epilogue's plain twin and the ResNet path that uses it, on
the CPU.

On the card a ResNet call that records no gradient, in ``eval()``, on a
channels_last map, runs each conv's norm, residual and ReLU as one epilogue
pass over parameters prepared once (``models/resnet.py``); every other call
runs the modules one by one. Here the CPU takes the modules, so the tests
that follow the prepared path let ``ops/conv_epilogue.py::serves`` accept a
CPU map: the path then runs with the kernel's plain twin. The kernel itself
is held to the twin on the card (``tests/test_torch_cuda_kernels.py``).
"""

import copy

import pytest
import torch

from runia_core_tpu_torch.models import resnet
from runia_core_tpu_torch.ops import conv_epilogue as epilogue
from runia_core_tpu_torch.ops.conv_epilogue import conv_epilogue, conv_epilogue_plain

torch.set_num_threads(1)

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _norm(c, gen):
    norm = resnet.BatchNorm(c)
    with torch.no_grad():
        norm.weight.uniform_(0.5, 1.5, generator=gen)
        norm.bias.normal_(0, 0.3, generator=gen)
        norm.running_mean.normal_(0, 0.5, generator=gen)
        norm.running_var.uniform_(0.5, 2.0, generator=gen)
    return norm.eval()


def _map(gen, dtype, layout, shape=(2, 16, 5, 7)):
    x = torch.randn(shape, generator=gen).to(dtype)
    return x.contiguous(memory_format=torch.channels_last) if layout == "channels_last" else x


@pytest.mark.parametrize("layout", ["channels_last", "nchw"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", ["norm_relu", "block_end", "block_end_projected"])
def test_the_twin_matches_the_modules_it_replaces(case, dtype, layout):
    """BatchNorm (eval) then ReLU; a block's end with the residual as it is
    or through the projection's norm. f32: the same up to the order of two
    roundings. bf16: the twin rounds once from f32 scales, the modules two
    or three times with bf16 scales, so the twin lies at least as close to
    the f64 result as they do, and within a few bf16 steps of them."""
    gen = torch.Generator().manual_seed(0)
    y, r = _map(gen, DTYPES[dtype], layout), _map(gen, DTYPES[dtype], layout)
    norm, proj = _norm(16, gen), _norm(16, gen)
    scale, shift = norm.affine()
    sp, bp = proj.affine()
    c64 = [t.double()[:, None, None] for t in (scale, shift, sp, bp)]
    exact = y.double() * c64[0] + c64[1]
    with torch.no_grad():
        if case == "norm_relu":
            want, args = torch.relu(norm(y)), (y, scale, shift)
        elif case == "block_end":
            want, args = torch.relu(r + norm(y)), (y, scale, shift, r)
            exact = exact + r.double()
        else:
            want, args = torch.relu(proj(r) + norm(y)), (y, scale, shift, r, sp, bp)
            exact = exact + r.double() * c64[2] + c64[3]
    exact = torch.relu(exact)
    got = conv_epilogue_plain(*args)
    assert got.dtype == y.dtype and got.shape == y.shape
    assert torch.equal(got, conv_epilogue(*args))  # a CPU map takes the twin
    top = float(exact.abs().max())
    if dtype == "f32":
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * top)
        return
    assert float((got.double() - exact).abs().max()) <= float((want.double() - exact).abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -6, atol=2 ** -6 * top)


def _serve_the_cpu(monkeypatch):
    """Let the prepared path serve CPU maps (with the kernel's plain twin)."""
    def serves(x, channels=()):
        return (x.dtype in epilogue.MAP_DTYPES and x.ndim == 4 and x.is_contiguous(memory_format=torch.channels_last)
                and all(c % epilogue.width(x.dtype) == 0 for c in channels))

    monkeypatch.setattr(epilogue, "serves", serves)


def _model(block, gen, dtype=torch.float32):
    """A small randomised ResNet: every norm's statistics and scales away
    from the identity, so a wrong fold or a missed residual shows."""
    if block == "basic":
        model = resnet.ResNet((1, 2), resnet.ResNetBlock, 10, num_filters=8, cifar_stem=True, dtype=dtype,
                              device="cpu")
    else:
        model = resnet.ResNet((1, 1), resnet.BottleneckResNetBlock, 10, num_filters=8, torch_padding=True,
                              dtype=dtype, device="cpu")
    model.init_weights(gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, resnet.BatchNorm):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0, 0.1, generator=gen)
                m.running_mean.normal_(0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    return model


def _images(gen, block):
    return torch.rand((2, 16 if block == "basic" else 30, 16 if block == "basic" else 30, 3), generator=gen)


def _run(model, images, taps=("stem", "block1", "pre_pool", "penultimate")):
    logits, out = resnet.build_tapped_forward(model, taps)(images)
    return (logits, *(out[t] for t in taps))


def _prepared_tensors(model):
    return [m.__dict__["_prepared"] for m in model.modules() if m.__dict__.get("_prepared")]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("block", ["basic", "bottleneck"])
def test_the_prepared_path_matches_the_modules(monkeypatch, block, dtype):
    """Logits and taps of the prepared path (one epilogue a conv) against
    the modules' path on the same weights: f32 to 1e-5 of the largest
    value; bf16 within the modules' own extra roundings."""
    gen = torch.Generator().manual_seed(1)
    model, images = _model(block, gen, DTYPES[dtype]), _images(gen, block)
    want = _run(model, images)
    assert not _prepared_tensors(model)
    _serve_the_cpu(monkeypatch)
    got = _run(model, images)
    assert _prepared_tensors(model)  # the path ran
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        top = float(w.float().abs().max())
        tol = 1e-5 if dtype == "f32" else 0.05
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol * top)


def _edit(model, how, gen):
    block = model.stage1_block0
    with torch.no_grad():
        if how == "load_state_dict":
            state = {k: v + 0.05 * torch.randn(v.shape, generator=gen) if v.is_floating_point() else v
                     for k, v in model.state_dict().items()}
            model.load_state_dict(state)
        elif how == "in_place_weight":
            block.Conv_0.weight.mul_(-1.5)
        elif how == "in_place_statistics":
            block.BatchNorm_0.running_var.mul_(4.0)
            block.BatchNorm_0.running_mean.add_(0.3)
        elif how == "replaced_parameter":
            block.Conv_0.weight = torch.nn.Parameter(torch.randn(block.Conv_0.weight.shape, generator=gen))
        elif how == "head":
            model.head.weight.mul_(2.0)
            model.head.bias.add_(1.0)
        else:  # the compute dtype
            model.dtype = torch.bfloat16


@pytest.mark.parametrize("how", ["load_state_dict", "in_place_weight", "in_place_statistics", "replaced_parameter",
                                 "head", "dtype"])
def test_an_edit_of_the_weights_remakes_the_prepared_copy(monkeypatch, how):
    """After an eager call made the prepared copy, the weights change; the
    next eager call gives the new weights' outputs, as the modules do."""
    gen = torch.Generator().manual_seed(2)
    model, images = _model("basic", gen), _images(gen, "basic")
    twin = copy.deepcopy(model)
    _serve_the_cpu(monkeypatch)
    before = _run(model, images)
    _edit(model, how, torch.Generator().manual_seed(3))
    _edit(twin, how, torch.Generator().manual_seed(3))
    got = _run(model, images)
    monkeypatch.undo()
    want = _run(twin, images)
    assert not torch.allclose(got[0].float(), before[0].float())
    for g, w in zip(got, want):
        top = float(w.float().abs().max())
        tol = 0.05 if how == "dtype" else 1e-5
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol * top)


@pytest.mark.parametrize("mode", ["eval_with_gradient", "train", "remat"])
def test_calls_that_record_a_gradient_or_train_take_the_modules(monkeypatch, mode):
    """An eval call that records a gradient (an input-gradient baseline),
    ``train()`` and ``remat``: with the prepared path allowed on the CPU
    they still run the modules, with outputs, input and weight gradients
    and running statistics equal to those of the path the CPU takes."""
    gen = torch.Generator().manual_seed(4)
    images = _images(gen, "basic")
    model = _model("basic", gen)
    if mode == "remat":
        model.remat = True
    if mode != "eval_with_gradient":
        model.train()
    twin = copy.deepcopy(model)

    def step(m):
        x = images.clone().requires_grad_(True)
        logits, taps = m(x)
        (logits.square().sum() + taps["pre_pool"].sum()).backward()
        return [logits.detach(), x.grad] + [p.grad for p in m.parameters()] + list(m.buffers())

    want = step(twin)
    _serve_the_cpu(monkeypatch)
    got = step(model)
    assert not _prepared_tensors(model)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_the_cpu_launches_no_epilogue_and_prepares_nothing():
    gen = torch.Generator().manual_seed(5)
    model, images = _model("bottleneck", gen), _images(gen, "bottleneck")
    before = conv_epilogue.launches
    _run(model, images)
    assert conv_epilogue.launches == before and not _prepared_tensors(model)


def _hook(model, name, kind):
    """A forward hook (or pre-hook) on the submodule ``name`` that keeps
    what the module gave (or was given)."""
    seen = []
    module = model.get_submodule(name)
    if kind == "pre":
        module.register_forward_pre_hook(lambda m, args: seen.append(args[0].clone()))
    else:
        module.register_forward_hook(lambda m, args, out: seen.append(out.clone()))
    return seen


@pytest.mark.parametrize("name,kind", [("stage1_block0.Conv_1", "out"), ("stage2_block1.BatchNorm_0", "out"),
                                       ("stage1_block0.Conv_0", "pre"), ("bn_init", "out"), ("conv_init", "out")])
def test_a_hooked_conv_or_norm_sees_what_the_modules_give_it(monkeypatch, name, kind):
    """A forward hook on a conv or a norm (``extraction.tap_torch_model``,
    ``utils.profiling.profile_taps``) sees the tensor the modules' path
    gives it: its block (or the stem) declines the epilogue, and every
    other block still takes it."""
    gen = torch.Generator().manual_seed(6)
    model, images = _model("basic", gen), _images(gen, "basic")
    twin = copy.deepcopy(model)
    want_seen = _hook(twin, name, kind)
    want = _run(twin, images)
    seen = _hook(model, name, kind)
    _serve_the_cpu(monkeypatch)
    got = _run(model, images)
    assert len(seen) == len(want_seen) == 1
    torch.testing.assert_close(seen[0], want_seen[0], rtol=0, atol=0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5 * float(w.abs().max()))
    stem = name in ("bn_init", "conv_init")
    hooked = model if stem else model.get_submodule(name.split(".")[0])
    assert not any(m.__dict__.get("_prepared") for m in (model.conv_init, model.bn_init) if stem)
    assert not any(m.__dict__.get("_prepared") for m in hooked.children() if not stem)
    assert model.stage2_block0.Conv_0.__dict__.get("_prepared")  # an unhooked block took the epilogue


def test_a_global_forward_hook_turns_the_epilogue_off(monkeypatch):
    gen = torch.Generator().manual_seed(7)
    model, images = _model("bottleneck", gen), _images(gen, "bottleneck")
    _serve_the_cpu(monkeypatch)
    handle = torch.nn.modules.module.register_module_forward_hook(lambda m, args, out: None)
    try:
        _run(model, images)
    finally:
        handle.remove()
    assert not _prepared_tensors(model)
    _run(model, images)
    assert _prepared_tensors(model)


@pytest.mark.parametrize("how", ["moved", "pickled", "deep_copied", "source_gone"])
def test_the_prepared_copy_goes_with_a_move_and_holds_its_sources_weakly(monkeypatch, how):
    """``model.to(...)`` drops the prepared copies; pickling or copying a
    model carries none; the copy keeps no source tensor alive."""
    import gc
    import io
    import weakref

    gen = torch.Generator().manual_seed(8)
    model, images = _model("basic", gen), _images(gen, "basic")
    _serve_the_cpu(monkeypatch)
    _run(model, images)
    assert _prepared_tensors(model)
    if how == "moved":
        model.to(torch.float64)
        assert not _prepared_tensors(model)
    elif how == "pickled":
        buffer = io.BytesIO()
        torch.save(model, buffer)
        buffer.seek(0)
        loaded = torch.load(buffer, weights_only=False)
        assert _prepared_tensors(model) and not _prepared_tensors(loaded)
    elif how == "deep_copied":
        twin = copy.deepcopy(model)
        assert not _prepared_tensors(twin)
        torch.testing.assert_close(_run(twin, images)[0], _run(model, images)[0], rtol=0, atol=0)
    else:
        conv = model.stage1_block0.Conv_0
        old = weakref.ref(conv.weight)
        conv.weight = torch.nn.Parameter(conv.weight.detach().clone())
        gc.collect()
        assert old() is None


class _Program:
    """A stand-in for a captured graph: the prepared copies it read."""

    def __init__(self, **reads):
        self.workspaces = {("prepared", owner, torch.bfloat16): copy for owner, copy in reads.items()}


def test_a_program_cache_drops_programs_over_an_older_prepared_copy():
    """A new program that read another copy of some parameters than a cached
    one did drops that one (the weights were edited between the captures);
    programs over the same copies, over other parameters, or over none stay."""
    from runia_core_tpu_torch.utils.graphs import ProgramCache

    old, new, other = object(), object(), object()
    cache = ProgramCache(8)
    cache.get_or_build("a", lambda: _Program(conv=old, norm=other))
    cache.get_or_build("b", lambda: _Program(conv=old))
    cache.get_or_build("c", lambda: _Program(head=other))
    cache.get_or_build("d", lambda: object())
    cache.get_or_build("e", lambda: _Program(conv=old))
    assert list(cache.entries) == ["a", "b", "c", "d", "e"]
    cache.get_or_build("f", lambda: _Program(conv=new, norm=other))
    assert list(cache.entries) == ["c", "d", "f"]
