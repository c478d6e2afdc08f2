"""Traffic kind ``rows`` of the new-cell test: the program over all its
rows, call after call."""

import time

import torch


class Load:
    def __init__(self, cfg, traffic, seed, program, device):
        self.program, self.answers = program, []

    def warmup(self):
        self.program.forward(self.program.rows)

    def window(self, seconds):
        start = time.perf_counter()
        while not self.answers or time.perf_counter() - start < seconds:
            self.answers.append(self.program.forward(self.program.rows))
        elapsed = time.perf_counter() - start
        rows = len(self.answers) * self.program.rows.shape[0]
        failed = sum(int((~torch.isfinite(a)).any(dim=1).sum()) for a in self.answers)
        return {"seconds": elapsed, "images": rows, "attempted": rows, "failed": failed,
                "end_to_end": {"rows_per_s": rows / elapsed}}

    def traced(self):
        self.warmup()
        return 1, self.program.rows.shape[0]

    def sample(self, rng):
        return [self.answers[int(i)] for i in rng.choice(len(self.answers), size=min(3, len(self.answers)))]
