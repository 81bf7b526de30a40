"""Out-of-core streaming image input (counterpart of
``keystone_tpu/loaders/streaming.py``).

The reference never materializes a dataset: it streams each tar archive
member by member and decodes one image at a time. Here a host-side bounded
pipeline per process does the same:

    tar paths ──(per-process shard: paths[rank::world])──▶ member bytes
      ──(window of decode futures, order-preserving)──▶ decoded arrays
      ──(fixed-shape assembly)──▶ (B, s, s, 3) batches + labels

At most ``decode_window`` raw or decoded images and one assembly batch are
alive at a time, whatever the dataset's size. Sharding is by tar file,
round-robin on the ``torch.distributed`` rank when a process group is
initialised (shard 0 of 1 otherwise): shards are disjoint and their union
is the whole dataset.

With a target size, decoding takes the native libjpeg path first
(``keystone_tpu_torch/native.py``: DCT-scaled draft decode and a triangle
resize, with the GIL released, so a thread pool scales across cores) and
PIL for an image the native path declines or when the library is absent;
both land within ±1/255 of a level. Without one, PIL decodes each image
at its native size.

This module imports neither torch nor jax when it is imported, so that
spawned decode workers, which unpickle ``_decode_payload`` from it, stay
free of both.
"""

from __future__ import annotations

import csv
import io
import multiprocessing
import os
import tarfile
from collections import deque
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import (
    Any,
    Callable,
    Dict,
    Iterator,
    List,
    Optional,
    Sequence,
    Tuple,
)

import numpy as np


def _decode_payload(args: Tuple[bytes, Optional[int]], use_native: bool = True):
    """Decode one image, ``(jpeg bytes, target size or None)`` -> an
    (H, W, 3) float32 RGB array of 0..255, or None for a stream that does
    not decode (a module-level function, so process-pool workers can
    unpickle it; they import only this module's PIL and numpy chain, as
    the package ``__init__``s are lazy).

    At a target size the native libjpeg path (``native/jpeg.cc`` through
    ``keystone_tpu_torch.native``) goes first: it releases the GIL for the
    whole decode, so a THREAD pool scales across cores. PIL decodes an
    image the native path declines (library absent, CMYK, a corrupt
    stream); both decode the JPEG DCT at draft scale and triangle-resize
    to the target, within ±1/255 of a level of each other."""
    data, decode_size = args
    if decode_size is not None and use_native:
        from keystone_tpu_torch.native import jpeg_decode_f32

        arr = jpeg_decode_f32(data, decode_size)
        if arr is not None:
            return arr
    from PIL import Image as PILImage

    try:
        img = PILImage.open(io.BytesIO(data))
        if decode_size is not None:
            # draft: decode the JPEG DCT at the coarsest scale still
            # >= target — the decode-speed lever at ImageNet scale
            img.draft("RGB", (decode_size, decode_size))
        img = img.convert("RGB")
        if decode_size is not None:
            img = img.resize(
                (decode_size, decode_size), PILImage.BILINEAR
            )
        return np.asarray(img, dtype=np.float32)
    except Exception:
        return None

__all__ = [
    "StreamingImageLoader",
    "StreamingImageNetLoader",
    "StreamingVOCLoader",
    "imagenet_label_fn",
    "voc_label_fn",
    "tar_shard_paths",
]


def tar_shard_paths(
    location: str,
    shard_index: Optional[int] = None,
    num_shards: Optional[int] = None,
) -> List[str]:
    """Tar files under ``location`` (a directory of ``.tar`` files, or one
    file) assigned to this process's shard, round-robin by file. Without
    ``shard_index`` and ``num_shards``, the shard is this process's
    ``torch.distributed`` rank of its world size when a process group is
    initialised, and shard 0 of 1 otherwise."""
    if os.path.isdir(location):
        paths = sorted(
            os.path.join(location, f)
            for f in os.listdir(location)
            if f.endswith(".tar")
        )
    else:
        paths = [location]
    if shard_index is None or num_shards is None:
        shard_index, num_shards = _process_shard()
    return paths[shard_index::num_shards]


def _process_shard() -> Tuple[int, int]:
    """(rank, world size) of an initialised ``torch.distributed`` process
    group, else (0, 1); torch is imported only here, when it is asked."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def imagenet_label_fn(labels_path: str) -> Callable[[str], Optional[int]]:
    """Member name -> class through the WNID map file ("n15075141 12"
    lines); a member whose WNID the file lacks maps to None."""
    label_map: Dict[str, int] = {}
    with open(labels_path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                label_map[parts[0]] = int(parts[1])

    def fn(name: str) -> Optional[int]:
        wnid = name.split("/")[0].split("_")[0]
        return label_map.get(wnid)

    return fn


def voc_label_fn(labels_path: str) -> Callable[[str], Optional[List[int]]]:
    """Member name -> its list of classes (0-based) through VOC's labels
    CSV (id, class, classname, traintesteval, filename rows)."""
    by_file: Dict[str, List[int]] = {}
    with open(labels_path) as f:
        for row in csv.DictReader(f):
            fname = row["filename"].split("/")[-1]
            by_file.setdefault(fname, []).append(int(row["class"]) - 1)

    def fn(name: str) -> Optional[List[int]]:
        return by_file.get(name.split("/")[-1])

    return fn


class StreamingImageLoader:
    """Bounded-memory tar → batch pipeline (see module docstring).

    Args:
      paths: tar files THIS process reads (use ``tar_shard_paths`` for
        the multi-host round-robin assignment).
      label_fn: member name -> label (int, list, or any object); None
        skips the member (a WNID the label file lacks).
      decode_size: if set, every image is decoded+resized to
        (decode_size, decode_size, 3) so batches are fixed-shape arrays;
        None keeps native sizes (``items()`` iteration only).
      cycle: read the tar list this many times (a small tar cycled to a
        large image count).
      decode_threads / decode_window: decode pool size and the bound on
        in-flight images (the RSS bound).
      decode_processes: when > 0, decode in a spawn-based PROCESS pool
        of this size instead of threads. With the native libjpeg path
        (the default when decode_size is set) the THREAD pool already
        scales across cores — the C decode releases the GIL — so
        processes only pay off on the PIL path, where PIL and numpy hold
        the GIL. Workers import neither torch nor jax.
      use_native_decode: use native/jpeg.cc (DCT-draft decode +
        triangle resize, ±1 level vs PIL) when decode_size is set;
        False forces the PIL path (parity testing).
    """

    def __init__(
        self,
        paths: Sequence[str],
        label_fn: Callable[[str], Optional[object]],
        decode_size: Optional[int] = None,
        cycle: int = 1,
        decode_threads: int = 8,
        decode_window: int = 64,
        limit: Optional[int] = None,
        decode_processes: int = 0,
        use_native_decode: bool = True,
    ):
        self.paths = list(paths)
        self.label_fn = label_fn
        self.decode_size = decode_size
        self.cycle = cycle
        self.decode_threads = decode_threads
        self.decode_window = decode_window
        self.limit = limit
        self.decode_processes = decode_processes
        self.use_native_decode = use_native_decode

    # -- raw member stream -------------------------------------------------

    def _iter_raw(self) -> Iterator[Tuple[str, object, bytes]]:
        """(name, label, jpeg bytes) for labeled members, streamed one
        tar member at a time (tarfile reads sequentially; nothing is
        extracted to disk or held beyond the current member)."""
        emitted = 0
        for _ in range(self.cycle):
            for path in self.paths:
                with tarfile.open(path) as tf:
                    for member in tf:
                        if not member.isfile():
                            continue
                        label = self.label_fn(member.name)
                        if label is None:
                            continue
                        f = tf.extractfile(member)
                        if f is None:
                            continue
                        yield member.name, label, f.read()
                        emitted += 1
                        if self.limit is not None and emitted >= self.limit:
                            return

    def items(self) -> Iterator[Tuple[str, object, np.ndarray]]:
        """Order-preserving decoded stream with a bounded window of
        decode futures in flight (the eager loaders' list materialized
        one element at a time)."""
        # both pools run the same module-level _decode_payload through
        # the concurrent.futures API: ProcessPoolExecutor (vs
        # multiprocessing.Pool) raises BrokenProcessPool if a spawn
        # worker is OOM-killed or segfaults mid-decode instead of
        # hanging the in-flight .get() forever
        if self.decode_processes > 0:
            ex = ProcessPoolExecutor(
                self.decode_processes,
                mp_context=multiprocessing.get_context("spawn"),
            )
        else:
            ex = ThreadPoolExecutor(self.decode_threads)
        with ex:
            yield from self._bounded_ordered_decode(
                lambda data: ex.submit(
                    _decode_payload,
                    (data, self.decode_size),
                    self.use_native_decode,
                ),
                lambda fut: fut.result(),
            )

    def _bounded_ordered_decode(
        self, submit, get
    ) -> Iterator[Tuple[str, object, np.ndarray]]:
        """The one window invariant both pools share: at most
        ``decode_window`` decodes in flight, results yielded in
        submission order, failed decodes skipped."""
        pending: deque = deque()
        for name, label, data in self._iter_raw():
            pending.append((name, label, submit(data)))
            if len(pending) >= self.decode_window:
                n, l, handle = pending.popleft()
                arr = get(handle)
                if arr is not None:
                    yield n, l, arr
        while pending:
            n, l, handle = pending.popleft()
            arr = get(handle)
            if arr is not None:
                yield n, l, arr

    # -- fixed-shape batches ----------------------------------------------

    def batches(
        self, batch_size: int, dtype=np.float32
    ) -> Iterator[Tuple[np.ndarray, List[object], int]]:
        """(images (B, s, s, 3) ``dtype``, labels, n_valid) batches; the
        final batch is zero-padded past n_valid. Requires decode_size.
        ``dtype=np.uint8`` quarters the batch's footprint — the right
        feed when the device's work starts with a cast anyway (the upload
        then carries raw pixels)."""
        if self.decode_size is None:
            raise ValueError("batches() requires decode_size")
        s = self.decode_size
        buf = np.zeros((batch_size, s, s, 3), dtype)
        labels: List[object] = []
        fill = 0
        for _, label, arr in self.items():
            buf[fill] = arr  # stores cast decode's f32 to ``dtype``
            labels.append(label)
            fill += 1
            if fill == batch_size:
                yield buf, labels, fill
                buf = np.zeros((batch_size, s, s, 3), dtype)
                labels = []
                fill = 0
        if fill:
            yield buf, labels, fill

    def featurized_batches(
        self, engine, batch_size: int
    ) -> Iterator[Tuple[Any, List[object], int]]:
        """(features (B, F) device tensor, labels, n_valid) batches: the
        decode stream feeds RAW uint8 into a serving engine
        (``serving.engine.CompiledPipeline`` — a fitted featurize chain
        ``compiled()``, or a model engine with ``featurize=``), so the
        upload carries pixels, not float32 features, and the cast and the
        featurize chain run in the engine's per-bucket CUDA graph: the
        loaders reach the same featurize code the serving engine runs.

        The engine enqueues its work and returns, so the decode of batch
        k + 1 overlaps the device's work on batch k. The final short
        batch is served zero-padded at ``batch_size`` rows (the engine
        pads to a bucket anyway, and one batch shape keeps one graph);
        slice the features to ``n_valid``. Callers own the sync point."""
        for buf, labels, n_valid in self.batches(batch_size, np.uint8):
            yield engine.apply(buf), labels, n_valid


def StreamingImageNetLoader(
    location: str,
    labels_path: str,
    decode_size: Optional[int] = None,
    shard_index: Optional[int] = None,
    num_shards: Optional[int] = None,
    **kw,
) -> StreamingImageLoader:
    """Sharded streaming ImageNet reader: labels through the WNID map file
    (``imagenet_label_fn``)."""
    return StreamingImageLoader(
        tar_shard_paths(location, shard_index, num_shards),
        imagenet_label_fn(labels_path),
        decode_size=decode_size,
        **kw,
    )


def StreamingVOCLoader(
    location: str,
    labels_path: str,
    decode_size: Optional[int] = None,
    shard_index: Optional[int] = None,
    num_shards: Optional[int] = None,
    **kw,
) -> StreamingImageLoader:
    """Sharded streaming VOC2007 reader: labels through the labels CSV
    (``voc_label_fn``)."""
    return StreamingImageLoader(
        tar_shard_paths(location, shard_index, num_shards),
        voc_label_fn(labels_path),
        decode_size=decode_size,
        **kw,
    )
