"""Input pipeline: sharded sampling, batch assembly, prefetch. A copy of
`poet_tpu/data/loader.py` (the port imports nothing of `poet_tpu`).

Replaces DataLoader + DistributedSampler + data_prefetcher
(data_utils/samplers.py, data_utils/data_prefetcher.py):
  * epoch-seeded shuffle and contiguous-chunk per-process sharding, matching
    DistributedSampler semantics (samplers.py:48-66) with the caller's
    process index and count: the data slot and the number of data slots
    (`parallel/mesh.py:Layout.data_index`, `n_data`), not the global rank,
    so every seq and model process of a slot loads the same images,
  * worker threads decode/augment images on the host, each item with its
    own (seed, epoch, index) generator, and copy each image into its row of
    the batch array, which `alloc(shape, dtype)` provides (e.g. pinned
    memory for an asynchronous upload; np.empty by default), so the batch
    is never stacked or copied again on one thread,
  * a background thread assembles batches ahead of the consumer; an
    optional `device_put_fn` moves each batch to the device there.

`dataset` is duck-typed: `__len__`, `ids`, `file_name(image_id)` and
`__getitem__(i, rng=)` -> (image (H, W, 3), target dict).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Tuple

import numpy as np

from poet_tpu_torch.data.structures import pad_targets


class PoseDataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        num_queries: int,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 42,
        process_index: int = 0,
        process_count: int = 1,
        num_workers: int = 4,
        with_jitter: bool = False,
        device_put_fn=None,          # (images, pad_mask, targets) -> device batch
        prefetch: int = 2,
        pad_to_full_batch: bool = False,
        alloc=np.empty,              # (shape, dtype) -> the batch's image array
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_queries = num_queries
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.num_workers = max(1, num_workers)
        self.with_jitter = with_jitter
        self.device_put_fn = device_put_fn
        self.prefetch = prefetch
        # Static-shape rule: a ragged final batch is padded with dummy rows
        # (zero images, n_boxes = 0, image_id = -1) so every batch has the
        # same shape and divides the device mesh; dummies cannot produce
        # matches, so metrics are unaffected.
        self.pad_to_full_batch = pad_to_full_batch
        self.alloc = alloc

    # -- sampling (DistributedSampler parity, samplers.py:48-66) ----------
    def _epoch_indices(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            g = np.random.default_rng(self.seed + epoch)
            indices = g.permutation(n)
        else:
            indices = np.arange(n)
        # pad to divisible, then contiguous-chunk split across processes
        total = int(np.ceil(n / self.process_count)) * self.process_count
        indices = np.concatenate([indices, indices[: total - n]])
        per = total // self.process_count
        return indices[self.process_index * per : (self.process_index + 1) * per]

    def steps_per_epoch(self) -> int:
        per = len(self._epoch_indices(0))
        return per // self.batch_size if self.drop_last else int(np.ceil(per / self.batch_size))

    # -- iteration ----------------------------------------------------------
    def epoch(self, epoch: int) -> Iterator[Tuple[np.ndarray, np.ndarray, dict]]:
        indices = self._epoch_indices(epoch)
        nb = len(indices) // self.batch_size if self.drop_last else int(
            np.ceil(len(indices) / self.batch_size)
        )
        batches = [
            indices[i * self.batch_size : (i + 1) * self.batch_size] for i in range(nb)
        ]

        pool = ThreadPoolExecutor(self.num_workers)
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def load_one(i, epoch_):
            rng = np.random.default_rng((self.seed, epoch_, int(i)))
            return self.dataset.__getitem__(int(i), rng=rng)

        def make_batch(idx_list):
            rows = self.batch_size if self.pad_to_full_batch else len(idx_list)
            out = {}
            lock = threading.Lock()

            def fill(k_i):
                k, i = k_i
                img, tgt = load_one(i, epoch)
                with lock:                   # the first image fixes the batch's shape
                    if "images" not in out:
                        out["images"] = self.alloc((rows,) + img.shape, img.dtype)
                images = out["images"]
                if images.shape[1:] != img.shape:
                    raise ValueError(f"image {i} is {img.shape}, the batch's "
                                     f"{images.shape[1:]}")
                images[k] = img              # each worker copies its own row
                return tgt

            tgt_list = list(pool.map(fill, enumerate(idx_list)))
            images = out["images"]
            if len(idx_list) < rows:         # the padded final batch: zero images
                n_pad = rows - len(idx_list)
                images[len(idx_list):] = 0
                tgt_list += [{"boxes": np.zeros((0, 4)), "labels": np.zeros((0,)),
                              "image_id": -1}] * n_pad
            pad_mask = np.zeros(images.shape[:3], dtype=bool)
            targets = pad_targets(
                tgt_list, self.num_queries, with_jitter=self.with_jitter
            )
            batch = (images, pad_mask, targets)
            if self.device_put_fn is not None:
                batch = self.device_put_fn(batch)
            return batch

        def producer():
            try:
                for b in batches:
                    if stop.is_set():
                        return
                    out_q.put(make_batch(b))
                out_q.put(None)
            except BaseException as e:  # propagate into the consumer
                out_q.put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            # a consumer that stops early leaves the producer blocked on a
            # full queue: make room so it can see `stop` and return
            while not out_q.empty():
                out_q.get_nowait()
            pool.shutdown(wait=False)
