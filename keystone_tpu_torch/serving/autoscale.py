"""Bucket autoscaling: propose a bucket set from observed traffic
(counterpart of ``keystone_tpu/serving/autoscale.py``, copied as it is:
pure functions over the metrics' row histogram).

Today the engine's row buckets are operator-chosen; this module closes
the ROADMAP loop ("autoscale the bucket set from observed traffic") by
reading the per-request size histogram a live ``ServingMetrics``
accumulates (``request_sizes``: valid rows per dispatch) and proposing
the ``k``-bucket set that minimizes expected padding waste — the
Clipper-style move of letting measured traffic drive the batching
policy instead of a config constant.

The optimization is exact: with sizes sorted ascending, an optimal
bucket set assigns each size to the smallest covering bucket, so
buckets partition the sizes into contiguous segments and each segment's
bucket must be its maximum size (any larger only adds padding). That
makes it a classic 1-D DP over segment boundaries —
``cost(i..j) = Σ count_s · (size_j − size_s)`` for sizes i..j — solved
in O(m²k) for m distinct observed sizes, which is tiny (m is bounded
by the largest bucket, typically ≤ a few hundred).

Deployment loop: scrape sizes (``/metrics`` exports them as
``keystone_serving_request_size_total``), call ``suggest_buckets``,
build a fresh ``CompiledPipeline`` with the proposal, warm it, swap.

``padding_waste`` is the OFFLINE model; the live truth is the
per-bucket goodput accounting every dispatch records
(``keystone_serving_goodput_rows_total`` / ``padded_rows_total`` and
the ``padding_efficiency`` gauge, serving/metrics.py).
``predicted_efficiency`` bridges the two so the gateway can log
model-vs-observed at each re-bucket and the bench can assert they
agree.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

from keystone_tpu_torch.serving.metrics import ServingMetrics

Histogram = Dict[int, int]


def _histogram_of(
    source: Union[ServingMetrics, Histogram]
) -> Histogram:
    if isinstance(source, ServingMetrics):
        source = source.request_sizes.snapshot()
    hist = {int(s): int(c) for s, c in source.items() if c > 0 and s and int(s) > 0}
    return hist


def padding_waste(hist: Histogram, buckets: Sequence[int]) -> int:
    """Total padded rows shipped serving ``hist`` through ``buckets``
    (requests above the largest bucket chunk through it, matching
    ``CompiledPipeline.apply``)."""
    buckets = sorted(buckets)
    top = buckets[-1]
    waste = 0
    for size, count in hist.items():
        tail = size % top if size > top else size
        if tail:
            covering = next(b for b in buckets if tail <= b)
            waste += (covering - tail) * count
    return waste


def predicted_efficiency(
    source: Union[ServingMetrics, Histogram], buckets: Sequence[int]
) -> Optional[float]:
    """The padding efficiency (valid rows over all rows shipped) the
    ``padding_waste`` model PREDICTS for serving ``source``'s histogram
    through ``buckets`` — the offline counterpart of the live
    ``ServingMetrics.padding_efficiency`` gauge, which is what makes
    ``suggest_buckets`` decisions auditable: the gateway logs observed
    efficiency next to this prediction at every re-bucket. None on an
    empty histogram."""
    hist = _histogram_of(source)
    valid = sum(size * count for size, count in hist.items())
    if not valid:
        return None
    return valid / (valid + padding_waste(hist, buckets))


def suggest_buckets(
    metrics: Union[ServingMetrics, Histogram],
    k: int,
    max_bucket: Optional[int] = None,
) -> Tuple[int, ...]:
    """The ≤``k``-bucket set minimizing expected padded rows over the
    observed per-request size histogram.

    ``metrics`` is a live ``ServingMetrics`` or a plain
    ``{size: count}`` histogram. ``max_bucket`` forces the largest
    bucket (it is always in the returned set — chunking needs it):
    observed sizes above it are modeled exactly as serving would pay
    for them (full ``max_bucket`` chunks are waste-free, only the
    ``size % max_bucket`` tail pads), matching ``padding_waste`` and
    ``CompiledPipeline.apply``. Returns an ascending tuple, possibly
    shorter than ``k`` when fewer distinct sizes were seen.

    Raises ``ValueError`` on an empty histogram — a proposal from zero
    observations would just be noise.
    """
    if k < 1:
        raise ValueError(f"need k >= 1 buckets, got {k}")
    hist = _histogram_of(metrics)
    if max_bucket is not None:
        folded: Histogram = {}
        for size, count in hist.items():
            if size > max_bucket:
                # serving-time chunking: full chunks pad nothing; the
                # tail is what the lower buckets have to cover
                size = size % max_bucket
                if size == 0:
                    continue
            folded[size] = folded.get(size, 0) + count
        hist = folded
        if not hist and _histogram_of(metrics):
            # all traffic chunks evenly through the forced bucket
            return (max_bucket,)
    if not hist:
        raise ValueError(
            "no observed request sizes to propose buckets from"
        )
    if max_bucket is not None:
        # a zero-count pseudo-size so the DP's top segment lands on the
        # forced bucket (its own waste contribution is zero)
        hist = dict(hist)
        hist[max_bucket] = hist.get(max_bucket, 0)

    sizes = sorted(hist)
    counts = [hist[s] for s in sizes]
    m = len(sizes)
    if m <= k:
        return tuple(sizes)

    # seg_cost[i][j]: padded rows if sizes[i..j] share bucket sizes[j]
    pref = [0] * (m + 1)  # pref[t] = counts[0] + ... + counts[t-1]
    for t in range(m):
        pref[t + 1] = pref[t] + counts[t]
    seg_cost = [[0] * m for _ in range(m)]
    for i in range(m):
        acc = 0
        for j in range(i + 1, m):
            # going j-1 -> j raises the segment bucket to sizes[j]:
            # every request in sizes[i..j-1] pays the difference
            acc += (sizes[j] - sizes[j - 1]) * (pref[j] - pref[i])
            seg_cost[i][j] = acc

    INF = float("inf")
    # best[j][b]: min waste covering sizes[0..j] with exactly b buckets
    best = [[INF] * (k + 1) for _ in range(m)]
    cut = [[-1] * (k + 1) for _ in range(m)]
    for j in range(m):
        best[j][1] = seg_cost[0][j]
    for b in range(2, k + 1):
        for j in range(b - 1, m):
            for i in range(b - 1, j + 1):
                # last segment is sizes[i..j]
                prev = best[i - 1][b - 1]
                if prev + seg_cost[i][j] < best[j][b]:
                    best[j][b] = prev + seg_cost[i][j]
                    cut[j][b] = i

    buckets = []
    j, b = m - 1, k
    while b >= 1:
        if b == 1:
            buckets.append(sizes[j])
            break
        i = cut[j][b]
        buckets.append(sizes[j])
        j, b = i - 1, b - 1
    return tuple(sorted(buckets))
