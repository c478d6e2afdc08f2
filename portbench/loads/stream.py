"""Traffic kind ``stream``: a closed loop of one client, one frame a request.

A frame is ``frame_images`` camera images already on the device, taken
from a seeded pool of ``pool_frames`` frames in a seeded order. Request r
makes a generator seeded with (seed, r), calls the scorer (its CUDA-graph
replay) and waits until the logits and scores are on the host; the next
request leaves when that one is back. Latency is from the moment the request
leaves (the generator made) to its scores on the host, for every request of the
window.

Parameters (``traffic/<name>.json``): ``frame_images``, ``pool_frames``,
``warmup_requests``, ``trace_seconds``, ``sample`` (requests compared with
the reference).
"""

from __future__ import annotations

import time
from typing import List, Tuple

import numpy as np
import torch

from portbench import inputs


class Load:
    def __init__(self, cfg: dict, traffic: dict, seed: int, program, device):
        self.cfg, self.traffic, self.seed, self.program, self.device = cfg, traffic, seed, program, device
        size, per = cfg["image_size"], traffic["frame_images"]
        pool = inputs.images_u8(traffic["pool_frames"] * per, size, size, device, seed, inputs.TAGS["pool"])
        self.pool_u8 = pool.reshape(traffic["pool_frames"], per, size, size, 3)
        self.pool = inputs.to_float(self.pool_u8)
        rng = np.random.default_rng(inputs.seed_word(seed, inputs.TAGS["frames"]))
        self.order = rng.permutation(traffic["pool_frames"])
        self.requests = 0
        self.results: List[Tuple[int, torch.Tensor, torch.Tensor]] = []  # (request, logits, scores) of the window
        self.latencies: List[float] = []

    def frame(self, request: int) -> int:
        return int(self.order[request % len(self.order)])

    def request(self) -> Tuple[int, torch.Tensor, torch.Tensor, float]:
        r = self.requests
        self.requests += 1
        word = inputs.seed_word(self.seed, inputs.TAGS["request"], r)
        images = self.pool[self.frame(r)]
        start = time.perf_counter()
        generator = torch.Generator(device=self.device).manual_seed(word)
        logits, scores = self.program.scorer(images, generator)
        logits, scores = logits.cpu(), scores.cpu()
        return r, logits, scores, time.perf_counter() - start

    def warmup(self) -> None:
        for _ in range(self.traffic["warmup_requests"]):
            self.request()

    def window(self, seconds: float) -> dict:
        start = time.perf_counter()
        while True:
            r, logits, scores, latency = self.request()
            self.results.append((r, logits, scores))
            self.latencies.append(latency)
            elapsed = time.perf_counter() - start
            if elapsed >= seconds:
                break
        failed = sum(int(not (torch.isfinite(s).all() and torch.isfinite(l).all())) for _, l, s in self.results)
        ms = np.asarray(self.latencies) * 1e3
        images = len(self.results) * self.traffic["frame_images"]
        return {"seconds": elapsed, "images": images, "attempted": len(self.results), "failed": failed,
                "end_to_end": {"latency_p50_ms": float(np.percentile(ms, 50)),
                               "latency_p95_ms": float(np.percentile(ms, 95))}}

    def traced(self) -> Tuple[int, int]:
        """Requests until ``trace_seconds`` have passed; (requests, images)."""
        requests, start = 0, time.perf_counter()
        while requests == 0 or time.perf_counter() - start < self.traffic["trace_seconds"]:
            self.request()
            requests += 1
        return requests, requests * self.traffic["frame_images"]

    def batch_images(self) -> torch.Tensor:
        """One request's images."""
        return self.pool[self.frame(0)]

    def sample(self, rng: np.random.Generator) -> List[dict]:
        """The requests to compare, drawn over the whole window, and the
        seeds each drew its keep-weights from."""
        per = self.traffic["frame_images"]
        picked = np.sort(rng.choice(len(self.results), size=min(self.traffic["sample"], len(self.results)),
                                    replace=False))
        blocks = []
        for i in picked:
            r, logits, scores = self.results[int(i)]
            blocks.append({
                "images": self.pool[self.frame(r)],
                "draw": (per, (self.seed, inputs.TAGS["request"], r)),
                "rows": torch.arange(per, device=self.device),
                "logits": logits, "scores": scores,
            })
        return blocks
