"""Drive the PyTorch port's flagship serving path on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. check that a CUDA card is there, and print its name and power limit;
2. build the CUDA kernels from ``keystone_tpu_torch/csrc`` (nvcc, sm_90a)
   and print what ptxas reports of each: registers, shared memory, spills;
3. hold each kernel against its plain PyTorch version on the card, at
   ragged shapes (random dense operators, and real SIFT operators cropped
   so their bands straddle the kernel's tiles, with a zero row and column)
   and at the full-width shapes of the serving path (B = 64 images of
   256x256), and time the kernel, the plain version and a one-call
   PyTorch yardstick with CUDA events; each bound counts the FLOPs of the
   operators' nonzero bands (the dense count is kept beside it);
4. serve the ImageNetSiftLcsFV configuration (SIFT step 3 / bin 4 /
   4 scales, LCS 4/16/6, desc_dim 64, vocab 32 → 8,192 features, a
   seeded 8,192 x 1,000 linear head, top-5) through buckets (8, 64),
   check every kernel's launch count, and hold the first 8 images'
   features and top-5 against a CPU run of the port (plain versions);
5. time examples/sec per bucket.

Prints the kernel table as one JSON line, then, last, the result line
``{"ok": true, "device": {...}}``. Writes the full record to
``chiprun_out/chip_smoke.json``. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from keystone_tpu_torch import _cuda  # noqa: E402
from keystone_tpu_torch.convert import model_head  # noqa: E402
from keystone_tpu_torch.ops.images import fv_kernel, kernels, sift  # noqa: E402
from keystone_tpu_torch.ops.images.lcs import _lcs_sampling_matrix  # noqa: E402
from keystone_tpu_torch.serving.featurize import (  # noqa: E402
    build_flagship_featurize_pipeline,
)

# H100 SXM data sheet, dense, at the 700 W limit: float32 on the CUDA
# cores (no tensor cores; the kernels run float32 FMA) and HBM3 rate
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

IMG, B = 256, 64
CONF = dict(
    img=IMG, desc_dim=64, vocab=32, sift_step=3, sift_bin=4, sift_scales=4,
    sift_scale_step=1, lcs_stride=4, lcs_border=16, lcs_patch=6, seed=7,
)
CLASSES, TOP_K = 1000, 5
BUCKETS = (8, 64)
REQUESTS = (1, 8, 37, 64)
RTOL_SANDWICH, ATOL_SANDWICH = 1e-4, 1e-4
RTOL_FV, ATOL_FV = 1e-3, 1e-4
RTOL_FEAT, ATOL_FEAT = 1e-4, 1e-5


def log(*a):
    print(*a, flush=True)


def time_ms(fn, reps=10, warmup=2):
    """Median of ``reps`` CUDA-event timings of ``fn()``, in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(flops, nbytes):
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def max_abs_err(got, want, rtol, atol, what):
    got, want = (torch.as_tensor(t) for t in (got, want))
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{what}: {int(bad.sum())} of {bad.numel()} entries outside "
            f"rtol {rtol} / atol {atol}; max abs err {float(err.max())}"
        )
    return float(err.max())


def sift_inputs(imgs_u8, dev):
    """The (mag, orient) and sampling matrices the SIFT path gives the
    kernel at each scale, from raw images."""
    x = (imgs_u8.to(torch.float32) / 255.0) @ torch.tensor(
        (0.2989, 0.5870, 0.1140), device=dev
    )
    out = []
    for scale in range(CONF["sift_scales"]):
        bin_size = CONF["sift_bin"] + 2 * scale
        step = CONF["sift_step"] + scale * CONF["sift_scale_step"]
        bnd = (1 + 2 * CONF["sift_scales"]) - 3 * scale
        sm = sift._sep_conv2d(x, sift._gaussian_kernel(bin_size / sift.MAGNIF))
        gy, gx = torch.gradient(sm, dim=(1, 2))
        mag = torch.sqrt(gx * gx + gy * gy).contiguous()
        ang = torch.remainder(torch.atan2(gy, gx), 2.0 * np.pi)
        t = (ang / (2.0 * np.pi) * 8).contiguous()
        nf = (IMG - 1 - bnd - 3 * bin_size) // step + 1
        a = sift._sampling_matrix(IMG, nf, bin_size, step, bnd)
        ayt, ax = torch.as_tensor(a.T.copy(), device=dev), torch.as_tensor(a, device=dev)
        out.append((mag, t, ayt, ax, kernels.sift_bands(ayt, ax)))
    return out


def band_flops(row_bands, col_bands, z_cols, t1_rows, reps):
    """FLOPs of ``reps`` sandwiches ``At · Z · B`` over the operators'
    bands: 2 · (Σ band widths) · (other extent) per product, with the row
    bands of At, the column bands of B, Z's column count and T1 = At · Z's
    row count."""
    wr = int((row_bands[1] - row_bands[0]).sum())
    wc = int((col_bands[1] - col_bands[0]).sum())
    return 2 * reps * (wr * z_cols + wc * t1_rows)


def lcs_inputs(imgs_u8, dev):
    img = imgs_u8.to(torch.float32)
    s, st, sp = CONF["lcs_patch"], CONF["lcs_stride"], CONF["lcs_border"]
    keys = np.arange(sp, IMG - sp, st)
    offs = np.arange(-2 * s + s // 2 - 1, s + s // 2, s)
    a = _lcs_sampling_matrix(IMG, keys, offs, s)
    z = torch.cat([img, img * img], dim=-1).permute(0, 3, 1, 2).contiguous()
    return z, torch.as_tensor(a.T.copy(), device=dev), torch.as_tensor(a, device=dev)


def fv_library(x, means, variances, weights, thresh):
    """The FV statistics as a chain of PyTorch calls (bmm, softmax):
    the yardstick, never used by the port."""
    inv_var, proj, const = fv_kernel.gmm_terms(means, variances, weights)
    xt = x.transpose(1, 2)
    lhs = torch.cat([xt * xt, xt], dim=-1)
    rhs = torch.cat([-0.5 * inv_var, proj], dim=0)
    q = torch.softmax(torch.matmul(lhs, rhs) + const, dim=-1)
    q = q * (q > thresh)
    q = q / q.sum(-1, keepdim=True)
    s = torch.matmul(torch.cat([x, x * x], dim=1), q) / x.shape[2]
    return q.sum(1) / x.shape[2], s


def check_ragged(dev, gen):
    """Each kernel against its plain version at shapes that are no
    multiple of any tile (edges of M, N, H, W, m and k < 32), and on the
    paths the serving shapes do not take: W over one column chunk of B1's
    stage 1, a tile of all-zero rows and a group of all-zero columns, k
    over 32 in B3."""
    def r(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    for h, w, m, n in ((50, 70, 37, 45), (40, 300, 21, 37)):
        mag, t = r(3, h, w).abs(), r(3, h, w).abs() * 3
        ayt, ax = r(m, h), r(w, n)
        max_abs_err(kernels.sift_bin_sample(mag, t, ayt, ax),
                    kernels.sift_bin_sample_plain(mag, t, ayt, ax),
                    RTOL_SANDWICH, ATOL_SANDWICH, f"sift_bin_sample ragged W={w}")
    # real SIFT operators, cropped so the bands straddle the kernel's row
    # and column tiles, with 10 all-zero rows (a whole tile once sorted)
    # and 8 all-zero columns (a whole column group)
    mag, t = r(3, 50, 70).abs(), r(3, 50, 70).abs() * 3
    ayt = sift._sampling_matrix(50, 10, 4, 3, 9).T[3:38].copy()
    ax = sift._sampling_matrix(70, 17, 4, 3, 9)[:, 2:47].copy()
    ayt[5:15], ax[:, 8:16] = 0.0, 0.0
    ayt, ax = torch.as_tensor(ayt, device=dev), torch.as_tensor(ax, device=dev)
    bands = kernels.sift_bands(ayt, ax)
    want = kernels.sift_bin_sample_plain(mag, t, ayt, ax)
    for b in (bands, None):
        max_abs_err(kernels.sift_bin_sample(mag, t, ayt, ax, b), want,
                    RTOL_SANDWICH, ATOL_SANDWICH, "sift_bin_sample ragged banded")
    planes, at, bm = r(2, 5, 131, 133), r(67, 131), r(133, 129)
    max_abs_err(kernels.plane_sandwich(planes, at, bm),
                kernels.plane_sandwich_plain(planes, at, bm),
                RTOL_SANDWICH, ATOL_SANDWICH, "plane_sandwich ragged")
    for d, k, m in ((8, 7, 1500), (8, 40, 500)):
        x, means = r(2, d, m), r(d, k)
        variances, weights = 0.5 + r(d, k).abs(), torch.full((k,), 1 / k, device=dev)
        for g, w in zip(fv_kernel.fisher_vector_stats(x, means, variances, weights),
                        fv_kernel.fisher_vector_stats_plain(x, means, variances, weights)):
            max_abs_err(g, w, RTOL_FV, ATOL_FV, f"fisher_vector_stats ragged k={k}")


def check_kernels(dev, gen):
    """Phase 3: each kernel against its plain version at B = 64."""
    imgs = torch.randint(0, 256, (B, IMG, IMG, 3), dtype=torch.uint8,
                         device=dev, generator=gen)
    rows = []

    # B1 — all four SIFT scales, as one dispatch runs them
    scales = sift_inputs(imgs, dev)
    err = 0.0
    for mag, t, ayt, ax, bands in scales:
        got = kernels.sift_bin_sample(mag, t, ayt, ax, bands)
        want = kernels.sift_bin_sample_plain(mag, t, ayt, ax)
        err = max(err, max_abs_err(got, want, RTOL_SANDWICH, ATOL_SANDWICH,
                                   f"sift_bin_sample M={ayt.shape[0]}"))
    flops = sum(band_flops(bands[0], bands[1], IMG, ayt.shape[0], B * 8)
                for _, _, ayt, _, bands in scales)
    dense_flops = sum(2 * B * 8 * ayt.shape[0] * IMG * (IMG + ax.shape[1])
                      for _, _, ayt, ax, _ in scales)
    nbytes = sum(4 * (2 * B * IMG * IMG + ayt.numel() + ax.numel()
                      + B * 8 * ayt.shape[0] * ax.shape[1])
                 for _, _, ayt, ax, _ in scales)
    planes = [kernels.orientation_planes(m, t) for m, t, *_ in scales]
    b_ms, b_by = bound(flops, nbytes)
    rows.append(dict(
        name="sift_bin_sample", route="cuda",
        source="keystone_tpu_torch/csrc/sift_bin.cu",
        replaces="keystone_tpu/ops/images/pallas_kernels.py:76",
        max_abs_err=err,
        ms=time_ms(lambda: [kernels.sift_bin_sample(*s) for s in scales]),
        plain_ms=time_ms(lambda: [kernels.sift_bin_sample_plain(*s[:4]) for s in scales]),
        library_ms=time_ms(lambda: [
            torch.einsum("mh,bohw,wn->bomn", s[2], p, s[3])
            for s, p in zip(scales, planes)
        ]),
        bound_ms=b_ms, bound_by=b_by, flops=flops, dense_flops=dense_flops,
        bytes=nbytes,
        shapes=f"B={B} H=W={IMG} M=N in {[s[2].shape[0] for s in scales]}",
    ))
    del planes

    # B2 — LCS, P = 6
    z, at, bm = lcs_inputs(imgs, dev)
    got = kernels.plane_sandwich(z, at, bm)
    want = kernels.plane_sandwich_plain(z, at, bm)
    err = max_abs_err(got, want, RTOL_SANDWICH, ATOL_SANDWICH, "plane_sandwich")
    M = at.shape[0]
    flops = band_flops(kernels.band_extents(at, 1), kernels.band_extents(bm, 0),
                       IMG, M, B * 6)
    dense_flops = 2 * B * 6 * M * IMG * (IMG + M)
    nbytes = 4 * (z.numel() + at.numel() + bm.numel() + B * 6 * M * M)
    b_ms, b_by = bound(flops, nbytes)
    rows.append(dict(
        name="plane_sandwich", route="cuda",
        source="keystone_tpu_torch/csrc/sandwich.cu",
        replaces="keystone_tpu/ops/images/pallas_kernels.py:129",
        max_abs_err=err,
        ms=time_ms(lambda: kernels.plane_sandwich(z, at, bm)),
        plain_ms=time_ms(lambda: kernels.plane_sandwich_plain(z, at, bm)),
        library_ms=time_ms(lambda: torch.einsum("mh,bphw,wn->bpmn", at, z, bm)),
        bound_ms=b_ms, bound_by=b_by, flops=flops, dense_flops=dense_flops,
        bytes=nbytes,
        shapes=f"B={B} P=6 H=W={IMG} M=N={M}",
    ))
    del z

    # B3 — both branches' descriptor counts, d = 64, k = 32
    d, k = CONF["desc_dim"], CONF["vocab"]
    means = torch.randn(d, k, device=dev, generator=gen)
    variances = torch.ones(d, k, device=dev)
    weights = torch.ones(k, device=dev) / k
    xs = [torch.randn(B, d, m, device=dev, generator=gen) for m in (13165, 3136)]
    err = 0.0
    for x in xs:
        for g, w, name in zip(
            fv_kernel.fisher_vector_stats(x, means, variances, weights),
            fv_kernel.fisher_vector_stats_plain(x, means, variances, weights),
            ("s0", "s1", "s2"),
        ):
            err = max(err, max_abs_err(g, w, RTOL_FV, ATOL_FV,
                                       f"fisher_vector_stats m={x.shape[2]} {name}"))
    flops = sum(B * x.shape[2] * (8 * d * k + 12 * k) for x in xs)
    nbytes = sum(4 * (x.numel() + 2 * d * k + k + B * (1 + 2 * d) * k) for x in xs)
    b_ms, b_by = bound(flops, nbytes)
    rows.append(dict(
        name="fisher_vector_stats", route="cuda",
        source="keystone_tpu_torch/csrc/fv_stats.cu",
        replaces="keystone_tpu/ops/images/fv_pallas.py:80",
        max_abs_err=err,
        ms=time_ms(lambda: [fv_kernel.fisher_vector_stats(x, means, variances, weights) for x in xs]),
        plain_ms=time_ms(lambda: [fv_kernel.fisher_vector_stats_plain(x, means, variances, weights) for x in xs]),
        library_ms=time_ms(lambda: [fv_library(x, means, variances, weights, 1e-4) for x in xs]),
        bound_ms=b_ms, bound_by=b_by, flops=flops, bytes=nbytes,
        shapes=f"B={B} d={d} k={k} m in (13165, 3136)",
    ))
    return rows


def serve(dev, smi):
    """Phase 4 and 5: the flagship through buckets (8, 64)."""
    t0 = time.perf_counter()
    feat, feat_dim = build_flagship_featurize_pipeline(device=dev, **CONF)
    assert feat_dim == 8192, feat_dim
    rng = np.random.default_rng(11)
    W = (rng.standard_normal((feat_dim, CLASSES)) / np.sqrt(feat_dim)).astype(np.float32)
    icpt = (rng.standard_normal(CLASSES) * 0.01).astype(np.float32)
    model = model_head(W, icpt, TOP_K, dev)
    engine = model.compiled(buckets=BUCKETS, featurize=feat, device=dev)
    log(f"built the serving pipeline in {time.perf_counter() - t0:.3f} s")

    reqs = [rng.integers(0, 256, (n, IMG, IMG, 3), dtype=np.uint8) for n in REQUESTS]
    _cuda.reset_launches()
    outs = [engine.apply(r, sync=True) for r in reqs]
    launches = dict(_cuda.LAUNCHES)
    dispatches = sum(-(-n // engine.max_bucket) for n in REQUESTS)
    want = {"sift_bin_sample": 4 * dispatches, "plane_sandwich": dispatches,
            "fisher_vector_stats": 2 * dispatches}
    log(f"launches over {dispatches} dispatches: {launches} (expected {want})")
    assert launches == want, (launches, want)
    for o, n in zip(outs, REQUESTS):
        assert tuple(o.shape) == (n, TOP_K) and o.device.type == "cuda", o.shape

    # the first 8 images against the port on the CPU (plain versions)
    t1 = time.perf_counter()
    feat_cpu, _ = build_flagship_featurize_pipeline(device="cpu", **CONF)
    model_cpu = model_head(W, icpt, TOP_K, "cpu")
    raw8 = torch.as_tensor(reqs[1])
    f_cpu = feat_cpu._batch_run(raw8)
    top_cpu = model_cpu._batch_run(f_cpu)
    log(f"CPU reference for 8 images in {time.perf_counter() - t1:.3f} s")
    f_gpu = feat._batch_run(raw8.to(dev)).cpu()
    assert torch.isfinite(f_gpu).all()
    # SIFT descriptors, card vs CPU: the repo's golden bar (±1 of the
    # ×512-quantized values on >= 99.5 % of entries)
    ext = sift.SIFTExtractor(step=3, bin=4, num_scales=4, scale_step=1)
    gray = (raw8.to(torch.float32) / 255.0) @ torch.tensor((0.2989, 0.5870, 0.1140))
    s_cpu = ext.extract(gray)
    s_gpu = ext.extract(gray.to(dev)).cpu()
    sift_diff = (s_cpu - s_gpu).abs()
    sift_rec = {
        "entries": sift_diff.numel(),
        "differing": int((sift_diff > 0).sum()),
        "within_1_share": float((sift_diff <= 1).float().mean()),
    }
    log(f"SIFT card vs CPU: {sift_rec}")
    assert sift_rec["within_1_share"] >= 0.995, sift_rec
    feat_err = float((f_gpu - f_cpu).abs().max())
    feat_ok = bool(torch.allclose(f_gpu, f_cpu, rtol=RTOL_FEAT, atol=ATOL_FEAT))
    top_equal = bool(torch.equal(outs[1].cpu(), top_cpu))
    log(f"features card vs CPU: max abs err {feat_err} (allclose rtol "
        f"{RTOL_FEAT} atol {ATOL_FEAT}: {feat_ok}); top-5 equal: {top_equal}")
    assert feat_ok, feat_err
    assert top_equal

    # examples/sec per bucket (host-side uint8 batch in, top-5 on the card)
    throughput = {}
    for b in BUCKETS:
        batch = rng.integers(0, 256, (b, IMG, IMG, 3), dtype=np.uint8)
        engine.apply(batch, sync=True)
        times = []
        for _ in range(5):
            t = time.perf_counter()
            engine.apply(batch, sync=True)
            times.append(time.perf_counter() - t)
        med = statistics.median(times)
        throughput[b] = {"median_s": med, "ex_per_s": b / med, "runs_s": times}
        log(f"bucket {b}: {b / med:.1f} ex/s (median of 5, {med * 1e3:.2f} ms "
            f"per dispatch) on {smi}")

    # where the time of one bucket-64 dispatch goes, by device activity
    # (kernels and copies); the rest of the dispatch's wall time the
    # device sat idle
    batch = rng.integers(0, 256, (64, IMG, IMG, 3), dtype=np.uint8)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    engine.apply(batch, sync=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        engine.apply(batch, sync=True)
        wall_ms = (time.perf_counter() - t) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    events.sort(key=lambda e: -e.device_time_total)
    device_ms = sum(e.device_time_total for e in events) / 1e3
    top = [(e.key[:90], e.device_time_total / 1e3, e.count) for e in events[:15]]
    log(f"profile of one bucket-64 dispatch: wall {wall_ms:.3f} ms, device "
        f"busy {device_ms:.3f} ms, idle share {1 - device_ms / wall_ms:.3f}")
    for key, ms, n in top:
        log(f"  {ms:9.3f} ms  x{n:<4d} {key}")
    return {
        "launches": launches, "dispatches": dispatches, "sift": sift_rec,
        "feature_max_abs_err": feat_err, "top5_equal": top_equal,
        "throughput": throughput, "profile_wall_ms": wall_ms,
        "profile_device_ms": device_ms,
        "profile_top": top,
    }


def main():
    # -- 1. the card ----------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(smi)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    _cuda.build()
    log(f"built {sorted(_cuda.SOURCES)} in {time.perf_counter() - t0:.3f} s")
    ptxas = {name: [ln.strip() for ln in text.splitlines()
                    if "Compiling entry" in ln or "Used" in ln or "spill" in ln]
             for name, text in _cuda.BUILD_LOGS.items()}
    for name, lines in ptxas.items():
        for ln in lines:
            log(f"ptxas {name}: {ln}")

    # -- 3. kernels against their plain versions ------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    check_ragged(dev, gen)
    log("kernels match their plain versions at ragged shapes")
    rows = check_kernels(dev, gen)
    for r in rows:
        r["bound_share"] = r["bound_ms"] / r["ms"]
        log(f"{r['name']}: {r['ms']:.3f} ms (plain {r['plain_ms']:.3f}, "
            f"library {r['library_ms']:.3f} = {r['library_ms'] / r['ms']:.2f}x, "
            f"bound {r['bound_ms']:.3f} by {r['bound_by']}, share "
            f"{r['bound_share']:.3f}), max abs err {r['max_abs_err']:.3g} "
            f"[{r['shapes']}] on {smi}")
    torch.cuda.empty_cache()

    # -- 4, 5. serve ----------------------------------------------------
    served = serve(dev, smi)
    for r in rows:
        r["launches"] = served["launches"][r["name"]]

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": smi, "kernels": rows, "serve": served,
                   "ptxas": ptxas}, f, indent=1)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
