"""Traffic kind ``dataset``: offline scoring of a seeded uint8 dataset.

Each call is ``ScoringService(scorer, seed=...).score_dataset(images,
batch)``: a user's evaluation job over the whole split, one new service a
call, its seed drawn from (seed, call). Calls run back to back for the
whole window. The rate is all images of all calls over all the window's
time, the last call's overrun included.

Parameters (``traffic/<name>.json``): ``images``, ``batch``,
``max_in_flight``, ``warmup_calls``, ``trace_seconds`` (the traced stretch:
whole calls until it has passed), ``sample`` (answers compared with the
reference) and, optionally, ``stored_size``: the [height, width] at which the
images are stored, which the loader resizes to the configuration's size in
its host pass (``score_dataset(resize_to=...)``), and which the reference
resizes with its own code (``reference/resize.py``).
"""

from __future__ import annotations

import time
from typing import List, Tuple

import numpy as np
import torch

from portbench import inputs
from portbench.reference import resize


class Load:
    def __init__(self, cfg: dict, traffic: dict, seed: int, program, device):
        self.cfg, self.traffic, self.seed, self.program, self.device = cfg, traffic, seed, program, device
        size = cfg["image_size"]
        self.resize_to = (size, size) if "stored_size" in traffic else None
        height, width = traffic.get("stored_size", (size, size))
        self.images_u8 = inputs.images_u8(traffic["images"], height, width, device, seed,
                                          inputs.TAGS["data"]).cpu().numpy()
        self.calls = 0
        self.results: List[Tuple[int, torch.Tensor, torch.Tensor]] = []  # (call, logits, scores) of the window

    def service_seed(self, call: int) -> int:
        return inputs.seed_word(self.seed, inputs.TAGS["service"], call)

    def call(self) -> Tuple[int, torch.Tensor, torch.Tensor]:
        from runia_core_tpu_torch.inference import ScoringService

        call = self.calls
        self.calls += 1
        service = ScoringService(self.program.scorer, seed=self.service_seed(call),
                                 max_in_flight=self.traffic["max_in_flight"], device=self.device)
        logits, scores = service.score_dataset(self.images_u8, self.traffic["batch"], resize_to=self.resize_to)
        return call, logits, scores

    def warmup(self) -> None:
        for _ in range(self.traffic["warmup_calls"]):
            self.call()

    def window(self, seconds: float) -> dict:
        n = self.traffic["images"]
        start = time.perf_counter()
        while True:
            self.results.append(self.call())
            elapsed = time.perf_counter() - start
            if elapsed >= seconds:
                break
        images = n * len(self.results)
        failed = sum(int((~(torch.isfinite(s) & torch.isfinite(l).all(dim=1))).sum()) for _, l, s in self.results)
        return {"seconds": elapsed, "images": images, "attempted": images, "failed": failed,
                "end_to_end": {"img_per_s": images / elapsed}}

    def traced(self) -> Tuple[int, int]:
        """Whole calls until ``trace_seconds`` have passed; (calls, images)."""
        calls, start = 0, time.perf_counter()
        while calls == 0 or time.perf_counter() - start < self.traffic["trace_seconds"]:
            self.call()
            calls += 1
        return calls, calls * self.traffic["images"]

    def floats(self, rows) -> torch.Tensor:
        """The images ``rows`` of the dataset as the scorer takes them, on the
        device: scaled to [0, 1] and, where they are stored at another size,
        resized by the reference."""
        images = torch.from_numpy(self.images_u8[rows]).to(self.device)
        return inputs.to_float(images) if self.resize_to is None else resize.bilinear(images, self.resize_to)

    def batch_images(self) -> torch.Tensor:
        """One batch of the dataset as the loader makes it, on the device."""
        return self.floats(slice(0, self.traffic["batch"]))

    def sample(self, rng: np.random.Generator) -> List[dict]:
        """The answers to compare, drawn over all of the window's calls: for
        each batch that holds some, its rows, their images and the seeds of
        the generator that batch drew its keep-weights from."""
        n, batch = self.traffic["images"], self.traffic["batch"]
        total = n * len(self.results)
        groups: dict = {}
        for answer in np.sort(rng.choice(total, size=min(self.traffic["sample"], total), replace=False)):
            result, image = divmod(int(answer), n)
            groups.setdefault((result, image // batch), []).append(image)
        blocks = []
        for (result, batch_index), images in groups.items():
            call, logits, scores = self.results[result]
            idx = np.asarray(images)
            blocks.append({
                "images": self.floats(idx),
                "draw": (batch, (self.service_seed(call), batch_index)),
                "rows": torch.as_tensor(idx - batch_index * batch, device=self.device),
                "logits": logits[idx], "scores": scores[idx],
            })
        return blocks
