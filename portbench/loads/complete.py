"""Traffic kind ``complete``: a closed loop of clients, each sending its next
prompt when its last one's scores are on the host (editors asking for a
completion and its uncertainty score).

The program makes the prompts (``programs/<program>.py::make_inputs``): a
seeded pool of ``pool_prompts``, token ids drawn uniformly from the
vocabulary, lengths log-uniform over ``prompt_tokens``, and a warm-up pool.
Each client goes through the pool in a seeded order of its own, so a run's
window serves the same requests in the same order. A request is submitted
to the program's ``UncertaintyServer`` (``submit``) and ends when
``stream`` yields its scores; its latency runs from the
submission to that moment, on the host clock. When the window's time is up
the clients stop sending and the requests in flight are drained: every
request sent inside the window gives its latency, those that ended after
it too (they lean to the longest prompts, where the tail lies). Rates over
the window's seconds (``mfu.complete``) count the requests that ended
inside it (``ended``).

Parameters (``traffic/<name>.json``): ``clients``, ``new_tokens``,
``trace_seconds``, ``sample`` (requests compared with the reference).
"""

from __future__ import annotations

import math
import time
from typing import List, Tuple

import numpy as np

from portbench import inputs

TAGS = {"order": 103}


class Load:
    def __init__(self, cfg: dict, traffic: dict, seed: int, program, device):
        self.cfg, self.traffic, self.program = cfg, traffic, program
        n, clients = traffic["pool_prompts"], traffic["clients"]
        self.pool, self.warmup_pool = program.pool, program.warmup_pool
        self.orders = [np.random.default_rng(inputs.seed_word(seed, TAGS["order"], c)).permutation(n)
                       for c in range(clients)]
        self.sent = [0] * clients
        self.results: List[dict] = []  # the window's requests: prompt index, answer, scores, latency

    def _loop(self, seconds: float, prompts=None) -> Tuple[List[dict], float]:
        """Run the closed loop for ``seconds``, then drain; every request
        sent in it (``ended``: before its end), and its seconds. ``prompts``
        (a list) serves those, one client each, instead of the clients'
        orders."""
        server = self.program.server
        inflight = {}

        def send(client: int) -> None:
            if prompts is not None:
                index, prompt = -1, prompts[client]
            else:
                index = int(self.orders[client][self.sent[client] % len(self.pool)])
                self.sent[client] += 1
                prompt = self.pool[index]
            inflight[server.submit(prompt.tolist())] = (client, index, time.perf_counter())

        start = time.perf_counter()
        deadline = start + seconds
        for client in range(len(prompts) if prompts is not None else self.traffic["clients"]):
            send(client)
        done = []
        for rid, scores in server.stream():
            now = time.perf_counter()
            client, index, sent = inflight.pop(rid)
            result = server.completion(rid)
            done.append({"index": index, "tokens": list(result["tokens"]), "log_probs": result["log_probs"],
                         "entropies": result["entropies"], "scores": dict(scores), "latency": now - sent,
                         "ended": now <= deadline})
            if prompts is None and now <= deadline:
                send(client)
        return done, min(time.perf_counter(), deadline) - start

    def warmup(self) -> None:
        """Every warm-up prompt at once: the engine's programs were
        captured when it was built; this runs its host paths and scoring."""
        self._loop(math.inf, self.warmup_pool)

    def window(self, seconds: float) -> dict:
        self.results, elapsed = self._loop(seconds)
        failed = sum(int(len(r["tokens"]) != self.traffic["new_tokens"]
                         or not all(math.isfinite(v) for v in r["scores"].values())) for r in self.results)
        ms = np.asarray([r["latency"] for r in self.results]) * 1e3
        ended = [r for r in self.results if r["ended"]]
        tokens = sum(len(self.pool[r["index"]]) + len(r["tokens"]) for r in ended)
        return {"seconds": elapsed, "images": len(ended), "tokens": tokens, "attempted": len(self.results),
                "failed": failed, "end_to_end": {"latency_p95_ms": float(np.percentile(ms, 95)) if len(ms) else math.inf}}

    def traced(self) -> Tuple[int, int]:
        """The closed loop for ``trace_seconds`` and its drain; (requests, tokens) it served."""
        done, _ = self._loop(self.traffic["trace_seconds"])
        return len(done), sum(len(self.pool[r["index"]]) + len(r["tokens"]) for r in done)

    def sample(self, rng: np.random.Generator) -> List[dict]:
        """The window's requests to compare, drawn over the whole window."""
        picked = np.sort(rng.choice(len(self.results), size=min(self.traffic["sample"], len(self.results)),
                                    replace=False))
        return [dict(self.results[int(i)], prompt=self.pool[self.results[int(i)]["index"]]) for i in picked]
