"""The port's GenerationService (request batching over TorchGenerator),
mirroring the JAX package's service tests, with the JAX service's results
beside the port's on the same weights (tokens identical, log-probs within
1e-5)."""

import threading

import numpy as np
import pytest
import torch

import jax

from runia_core_tpu.llm import GenerationService as JaxService
from runia_core_tpu.llm import JaxGenerator
from runia_core_tpu.models import LlamaLM as JaxLlamaLM
from runia_core_tpu_torch.llm import GenerationService, TorchGenerator
from runia_core_tpu_torch.llm.generate import _PROGRAM_CACHE
from test_torch_continuous import _port

torch.set_num_threads(1)

CFG = dict(vocab_size=64, num_layers=2, num_heads=4, num_kv_heads=2, d_model=32, hidden_dim=64, max_len=64)
MAX_NEW = 5
PROMPTS = [[1, 2, 3, 4], [9, 8], [5, 5, 5], [7, 7, 7, 7]]


@pytest.fixture(scope="module")
def generators():
    jm = JaxLlamaLM(**CFG)
    params = jm.init(jax.random.key(0), np.zeros((1, 4), np.int32))
    return JaxGenerator(jm, params, max_new_tokens=MAX_NEW), TorchGenerator(_port(params, CFG), max_new_tokens=MAX_NEW)


def _served(service, prompts):
    try:
        futures = [service.submit(p) for p in prompts]
        return [f.result(timeout=120) for f in futures]
    finally:
        service.close()


def test_batched_results_match_direct_decode_and_jax(generators):
    jgen, gen = generators
    results = _served(GenerationService(gen, max_batch=8, max_wait_s=0.2), PROMPTS)
    jax_results = _served(JaxService(jgen, max_batch=8, max_wait_s=0.2), PROMPTS)
    for p, res, jres in zip(PROMPTS, results, jax_results):
        want = gen.generate_batch([p], do_sample=False, output_scores=False)
        assert res["prompt_length"] == len(p)
        np.testing.assert_array_equal(res["sequences"][0], want["sequences"][0])
        np.testing.assert_allclose(res["log_probs"], want["log_probs"][0], atol=1e-5)
        np.testing.assert_array_equal(res["sequences"], np.asarray(jres["sequences"]))
        np.testing.assert_allclose(res["log_probs"], np.asarray(jres["log_probs"]), atol=1e-5)


def test_submissions_from_several_threads(generators):
    """Four threads submit 16 prompts of mixed lengths; every result is the
    direct decode's."""
    gen = generators[1]
    rng = np.random.RandomState(2)
    prompts = [list(rng.randint(1, 64, rng.randint(2, 12))) for _ in range(16)]
    service = GenerationService(gen, max_batch=8, max_wait_s=0.05)
    futures = [None] * len(prompts)

    def submit(part):
        for i in range(part, len(prompts), 4):
            futures[i] = service.submit(prompts[i])

    threads = [threading.Thread(target=submit, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    try:
        results = [f.result(timeout=120) for f in futures]
    finally:
        service.close()
    for p, res in zip(prompts, results):
        want = gen.generate_batch([p], output_scores=False)
        np.testing.assert_array_equal(res["sequences"][0], want["sequences"][0])


def test_errors_propagate_to_futures(generators):
    service = GenerationService(generators[1], max_batch=2, max_wait_s=0.05)
    try:
        bad = service.submit([None])  # not a token id: the batch's decode raises
        with pytest.raises(BaseException):
            bad.result(timeout=120)
    finally:
        service.close()


def test_submit_after_close_raises(generators):
    service = GenerationService(generators[1])
    service.close()
    with pytest.raises(RuntimeError, match="closed"):
        service.submit([1, 2])


def test_close_drains_outstanding(generators):
    service = GenerationService(generators[1], max_batch=4, max_wait_s=0.05)
    futures = [service.submit([1, 2, 3]) for _ in range(3)]
    service.close()
    for f in futures:
        assert f.done() and f.result()["prompt_length"] == 3


def test_sampled_service(generators):
    results = _served(GenerationService(generators[1], max_batch=4, max_wait_s=0.1, do_sample=True,
                                        temperature=1.0), [[1, 2, 3]] * 4)
    assert len({tuple(r["sequences"][0][-MAX_NEW:].tolist()) for r in results}) > 1


def test_length_bucketing_collapses_shapes(generators):
    """Prompts of 3 and 5 tokens pad to one 16-token bucket: one batch
    program of two rows serves both."""
    gen = generators[1]
    service = GenerationService(gen, max_batch=2, max_wait_s=0.01, length_bucket=16)
    try:
        service.submit([1, 2, 3]).result(timeout=120)
        service.submit([4, 5, 6, 7, 8]).result(timeout=120)
        keys = [k for k in _PROGRAM_CACHE.entries if k[0] == "batch" and k[2]() is gen.model and k[4] == 2]
        assert len(keys) == 1, keys
    finally:
        service.close()
