"""loader_img_per_s: images a second of the port's loader alone
(``data.PrefetchLoader``, the native gather into pinned host memory) over
the cell's whole dataset at its batch, resizing where the traffic stores
the images at another size, as ``score_dataset`` runs it; host
clock. It moves ``img_per_s`` where the loader, not the card, sets the pace."""

import time


def read(ctx):
    from runia_core_tpu_torch.data import PrefetchLoader

    images = ctx.load.images_u8
    loader = PrefetchLoader(images, batch_size=ctx.traffic["batch"], device=None, pin_memory=True,
                            resize_to=ctx.load.resize_to)
    start = time.perf_counter()
    for _ in loader:
        pass
    return images.shape[0] / (time.perf_counter() - start)
