"""detector_ms: device ms of the port's detector on one batch of the cell's
PCA embeddings (LaREM: ``detectors.latent.md_score``; LaRED:
``kde_log_density`` against the fitted support), by CUDA events around the
replays of 20 calls captured in a CUDA graph (``utils.cuda_graph_time_ms``:
one LaREM call is shorter than the host's enqueue of it), replayed 5 times."""


def read(ctx):
    from runia_core_tpu_torch.detectors.latent import kde_log_density, md_score
    from runia_core_tpu_torch.utils import cuda_graph_time_ms

    state = ctx.program.detector_state
    batch = ctx.traffic["batch"]
    rows = ctx.program.embeddings[:batch]
    if rows.shape[0] < batch:
        rows = rows.repeat((batch + rows.shape[0] - 1) // rows.shape[0], 1)[:batch]
    if ctx.traffic["detector"]["name"] == "MD":
        return cuda_graph_time_ms(lambda: md_score(rows, state["feats_mean"], state["precision"]), iters=20)
    return cuda_graph_time_ms(lambda: kde_log_density(rows, state["train_embeddings"], state["bandwidth"]), iters=20)
