"""Linear-chain CRF sequence taggers (POS + NER) with exact inference
(counterpart of ``keystone_tpu/ops/nlp/crf.py``).

Reference: nodes/nlp/POSTagger.scala:24 and NER.scala:20 wrap Epic's
pre-trained linear-chain CRF / semi-CRF models; like the JAX package,
this module trains the same model family in-framework:

- **Emissions**: each token's fixed-K hashed context features (the
  package's stable FNV-1a, ``hashing_tf.stable_hash``) index rows of a
  ``(hash_dim, n_tags)`` weight matrix; a sentence's emission scores are
  one gather and sum on the device. String work stays on the host.
- **Transitions**: a dense ``(n_tags, n_tags)`` table plus start scores.
- **Likelihood**: the sentence NLL ``logZ − score(gold)`` runs the
  forward algorithm as a loop over time on a padded batch (a
  log-sum-exp and a ``where`` on the mask per step, as JAX's masked
  ``lax.scan``); autograd gives the exact gradient. L2 is part of the loss, and Adam
  (b1 0.9, b2 0.999, eps 1e-8: optax's defaults) takes the steps.
- **Decode**: max-plus Viterbi on the device with first-index argmax
  backpointers (``jnp.argmax``'s ties), then the path read back on the
  host from one copy of the backpointers. ``_TrainedCRFTagger``'s
  ``apply_batch`` decodes each ``_bucket`` group of sentences in one
  batched pass; padded steps carry the lattice unchanged, so each path is
  the one a single-sentence decode gives.
- **Constraints**: an optional additive transition mask (−1e9 on
  forbidden transitions) in both training and decode;
  ``CRFNEREstimator`` uses it to make BIO-invalid outputs impossible.

On CUDA one training step — the gather of the batch, the forward
algorithm, its gradient and Adam's update — is captured once in a CUDA
graph and replayed for every later batch (every batch has the same
shape: the tail of an epoch wraps, as in the JAX package, whose one
jitted step this replaces). The first steps run eagerly and are real
steps of the fit. Per-batch losses stay on the card and are read once
per convergence check.

Tensor work runs on ``device`` (``None`` means ``cuda``, raising
without it; ``"cpu"`` runs it on the CPU).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from keystone_tpu_torch._device import resolve_device
from keystone_tpu_torch.ops.nlp.hashing_tf import stable_hashes
from keystone_tpu_torch.ops.nlp.tagging import _emit_features, _emit_ner_features
from keystone_tpu_torch.parallel.dataset import Dataset
from keystone_tpu_torch.workflow.api import Estimator, Transformer

_NEG = -1e9  # additive "forbidden" score; safe headroom in f32
# eager steps before a training step is captured (they warm the optimizer
# state and the allocator on a side stream, as CUDA graph capture needs)
_WARM_STEPS = 3


# ---------------------------------------------------------------------------
# Exact inference on emission scores e: (..., L, T); leading dimensions
# are a batch of sentences.
# ---------------------------------------------------------------------------


def _lse(x, dim):
    """``torch.logsumexp``'s value for finite ``x``, with the max shift
    held constant: autograd's backward is then the softmax alone (the
    shift's terms cancel), a few kernels per call instead of a dozen."""
    m = torch.amax(x, dim=dim, keepdim=True).detach()
    return torch.log(torch.sum(torch.exp(x - m), dim=dim)) + m.squeeze(dim)


def log_partition(e, trans, start, mask):
    """log Z over all tag paths of the unmasked prefix. ``mask`` is
    (..., L) with 1.0 on real steps; mask[..., 0] must be 1. The steps
    of ``e`` are unbound once, so that their gradients are stacked once,
    not written into a zero tensor of ``e``'s size per step."""
    steps = e.unbind(-2)
    live = (mask > 0).unbind(-1)
    alpha = start + steps[0]
    for t in range(1, len(steps)):
        nxt = _lse(alpha[..., :, None] + trans, -2) + steps[t]
        alpha = torch.where(live[t][..., None], nxt, alpha)
    return _lse(alpha, -1)


def path_score(e, trans, start, tags, mask):
    """Unnormalized log-score of one tag path under the same masking.
    Every lookup is a ``gather``, whose backward adds into the table
    directly (an indexed read's backward sorts its indices first, and
    a batch repeats the same few transitions ~10⁵ times)."""
    tags = tags.long()
    gold_e = (torch.gather(e, -1, tags[..., None])[..., 0] * mask).sum(-1)
    pairs = tags[..., :-1] * trans.shape[1] + tags[..., 1:]
    gold_t = (trans.reshape(-1).gather(0, pairs.reshape(-1)).reshape(pairs.shape)
              * mask[..., 1:]).sum(-1)
    return gold_e + gold_t + start.gather(0, tags[..., 0].reshape(-1)).reshape(tags.shape[:-1])


def _viterbi_paths(e, trans, start, lengths) -> np.ndarray:
    """(B, L, T) emissions and (B,) lengths -> (B, L) int64 argmax paths
    on the host. Padded steps keep the lattice and point each tag at
    itself, so a path is valid on [:length] whatever the padding."""
    B, L, T = e.shape
    lengths = torch.as_tensor(lengths, device=e.device).reshape(B, 1)
    same = torch.arange(T, device=e.device)
    delta = start + e[:, 0]
    psis = []
    for t in range(1, L):
        scores = delta[:, :, None] + trans  # (B, prev, next)
        best_prev = torch.argmax(scores, dim=1)  # first index of the max
        nxt = torch.amax(scores, dim=1) + e[:, t]
        live = t < lengths
        psis.append(torch.where(live, best_prev, same))
        delta = torch.where(live, nxt, delta)
    last = torch.argmax(delta, dim=-1)
    if psis:
        back = torch.stack(psis, dim=1).cpu().numpy()  # (B, L - 1, T)
    path = np.empty((B, L), np.int64)
    path[:, L - 1] = last.cpu().numpy()
    rows = np.arange(B)
    for t in range(L - 2, -1, -1):
        path[:, t] = back[rows, t, path[:, t + 1]]
    return path


def viterbi(e, trans, start, length):
    """Exact argmax tag path of an (L, T) emission matrix (or a (B, L, T)
    batch with (B,) lengths), on ``e``'s device. ``e`` may be padded past
    ``length``; the path is valid on [:length]."""
    single = e.dim() == 2
    eb = e[None] if single else e
    lengths = torch.as_tensor(length).reshape(-1).expand(eb.shape[0])
    path = torch.as_tensor(_viterbi_paths(eb, trans, start, lengths), device=e.device)
    return path[0] if single else path


# ---------------------------------------------------------------------------
# Feature hashing / padding
# ---------------------------------------------------------------------------


def _encode_many(
    sentences: Sequence[Sequence[str]],
    feature_fn: Callable[[Sequence[str], int], List[str]],
    hash_dim: int,
) -> List[np.ndarray]:
    """Each sentence's (L, K) int32 hashed feature indices (K is fixed by
    ``feature_fn``), with the hashes of all sentences' features computed
    at once."""
    feats = [f for toks in sentences for i in range(len(toks)) for f in feature_fn(toks, i)]
    k = len(feature_fn(["x"], 0))
    flat = (stable_hashes(feats) % np.uint64(hash_dim)).astype(np.int32).reshape(-1, k)
    bounds = np.cumsum([0] + [len(t) for t in sentences])
    return [flat[a:b] for a, b in zip(bounds[:-1], bounds[1:])]


def _bucket(n: int) -> int:
    b = 8
    while b < n:
        b *= 2
    return b


def bio_transition_mask(
    tag_names: Sequence[str],
) -> Tuple[np.ndarray, np.ndarray]:
    """(trans_mask, start_mask) additive constraints for a BIO scheme:
    I-X may only follow B-X or I-X and may not start a sentence. Tags
    not shaped like B-/I- are unconstrained."""
    n = len(tag_names)
    tmask = np.zeros((n, n), np.float32)
    smask = np.zeros((n,), np.float32)
    for j, tj in enumerate(tag_names):
        if tj.startswith("I-"):
            ok_prev = {"B-" + tj[2:], "I-" + tj[2:]}
            for i, ti in enumerate(tag_names):
                if ti not in ok_prev:
                    tmask[i, j] = _NEG
            smask[j] = _NEG
    return tmask, smask


def _emissions(emit, idx):
    """(..., L, K) feature rows -> (..., L, T) summed emission scores:
    ``emit[idx].sum(-2)`` as an ``index_select``, whose backward adds
    into the table directly (the bias and other constant features
    repeat in every token of a batch)."""
    rows = emit.index_select(0, idx.reshape(-1).long())
    return rows.reshape(idx.shape + (emit.shape[1],)).sum(-2)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


class _CRFTrainer:
    """Parameters, Adam state and the padded corpus on one device, and one
    training step on the batch of rows named by ``sel`` (a static buffer):
    eager, or on CUDA a replay of the step captured by ``capture``. Each
    step writes its loss to ``losses[pos]`` on the device and advances
    ``pos``."""

    def __init__(self, idx, tags, mask, tmask, smask, hash_dim, lr, l2, batch, steps, dev):
        n_tags = tmask.shape[0]
        self.dev = dev
        self.idx = torch.as_tensor(idx, device=dev)
        self.tags = torch.as_tensor(tags, device=dev)
        self.mask = torch.as_tensor(mask, device=dev)
        self.tmask = torch.as_tensor(tmask, device=dev)
        self.smask = torch.as_tensor(smask, device=dev)
        self.l2 = l2
        self.emit = torch.zeros((hash_dim, n_tags), device=dev, requires_grad=True)
        self.trans = torch.zeros((n_tags, n_tags), device=dev, requires_grad=True)
        self.start = torch.zeros((n_tags,), device=dev, requires_grad=True)
        self.opt = torch.optim.Adam(
            [self.emit, self.trans, self.start], lr=lr, betas=(0.9, 0.999), eps=1e-8,
            capturable=dev.type == "cuda",
        )
        self.sel = torch.arange(batch, device=dev)
        self.losses = torch.zeros((steps,), device=dev)
        self.pos = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        self.graph = None
        self.capture_s = None

    def batch_nll(self, idx_b, tags_b, mask_b):
        trans = self.trans + self.tmask
        start = self.start + self.smask
        e = _emissions(self.emit, idx_b)
        nll = (log_partition(e, trans, start, mask_b)
               - path_score(e, trans, start, tags_b, mask_b)).sum() / mask_b.sum()
        reg = self.l2 * ((self.emit ** 2).sum() + (self.trans ** 2).sum()
                         + (self.start ** 2).sum())
        return nll + reg

    def _step(self):
        self.opt.zero_grad(set_to_none=True)
        loss = self.batch_nll(self.idx.index_select(0, self.sel),
                              self.tags.index_select(0, self.sel),
                              self.mask.index_select(0, self.sel))
        loss.backward()
        self.opt.step()
        self.losses.index_copy_(0, self.pos, loss.detach()[None])
        self.pos.add_(1)

    def step(self):
        if self.graph is not None:
            self.graph.replay()
        elif self.side is not None:
            # eager CUDA steps run on a side stream, as capture needs
            self.side.wait_stream(torch.cuda.current_stream(self.dev))
            with torch.cuda.stream(self.side):
                self._step()
            torch.cuda.current_stream(self.dev).wait_stream(self.side)
        else:
            self._step()

    def capture(self):
        """Capture one step (recording it runs nothing) for every later
        ``step`` to replay."""
        t = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        self.opt.zero_grad(set_to_none=True)
        with torch.cuda.graph(graph):
            self._step()
        self.graph = graph
        self.capture_s = time.perf_counter() - t

    def tables(self):
        with torch.no_grad():
            return (self.emit.detach().cpu().numpy(),
                    (self.trans + self.tmask).cpu().numpy(),
                    (self.start + self.smask).cpu().numpy())


def _prepare(sentences, feature_fn, hash_dim: int, constrain_bio: bool):
    """The padded corpus of a fit: (tag names, (n, lmax, K) int32 feature
    rows, (n, lmax) int64 tag ids, (n, lmax) float32 mask, the additive
    transition and start masks)."""
    sentences = [(t, g) for t, g in sentences if len(t) > 0]
    if not sentences:
        raise ValueError("CRF fit needs at least one non-empty sentence")
    tag_names = sorted({t for _, tags in sentences for t in tags})
    tag_id = {t: i for i, t in enumerate(tag_names)}
    n_tags = len(tag_names)
    k = len(feature_fn(["x"], 0))
    lmax = max(len(t) for t, _ in sentences)
    n = len(sentences)

    idx = np.zeros((n, lmax, k), np.int32)
    tags = np.zeros((n, lmax), np.int64)
    mask = np.zeros((n, lmax), np.float32)
    encoded = _encode_many([t for t, _ in sentences], feature_fn, hash_dim)
    for s, ((toks, gold), enc) in enumerate(zip(sentences, encoded)):
        idx[s, : len(toks)] = enc
        tags[s, : len(toks)] = [tag_id[g] for g in gold]
        mask[s, : len(toks)] = 1.0

    if constrain_bio:
        tmask, smask = bio_transition_mask(tag_names)
        # a gold path through a forbidden transition would score -1e9 and
        # swamp the f32 batch loss — reject it up front with a fixable error
        for toks, gold in sentences:
            ids = [tag_id[g] for g in gold]
            if smask[ids[0]] < 0 or any(
                tmask[a, b] < 0 for a, b in zip(ids[:-1], ids[1:])
            ):
                raise ValueError(
                    "gold tags violate the BIO constraint (e.g. I-X "
                    f"without a preceding B-X/I-X) in {toks!r} -> {gold!r}; "
                    "convert IOB1-style data to strict BIO or pass "
                    "constrain_bio=False"
                )
    else:
        tmask = np.zeros((n_tags, n_tags), np.float32)
        smask = np.zeros((n_tags,), np.float32)
    return tag_names, idx, tags, mask, tmask, smask


def _fit_crf(
    sentences: List[Tuple[List[str], List[str]]],
    feature_fn,
    hash_dim: int,
    n_epochs: int,
    lr: float,
    l2: float,
    seed: int,
    batch_size: int,
    constrain_bio: bool,
    device=None,
):
    dev = resolve_device(device)
    t_fit = time.perf_counter()
    tag_names, idx, tags, mask, tmask, smask = _prepare(
        sentences, feature_fn, hash_dim, constrain_bio)
    n, lmax = tags.shape
    encode_s = time.perf_counter() - t_fit

    full_batch = n <= batch_size
    batch = n if full_batch else batch_size
    steps_per_epoch = 1 if full_batch else -(-n // batch_size)
    tr = _CRFTrainer(idx, tags, mask, tmask, smask, hash_dim, lr, l2, batch,
                     steps_per_epoch, dev)
    rng = np.random.default_rng(seed)
    prev_loss = np.inf
    steps = 0
    epochs = 0
    t_train = time.perf_counter()
    for epoch in range(n_epochs):
        tr.pos.zero_()
        if full_batch:
            order = None
        else:
            order = rng.permutation(n)
            # wrap the tail so every batch keeps the captured shape
            order = np.concatenate([order, order[: (-n) % batch_size]])
            order = torch.as_tensor(order, device=dev)
        for lo in range(0, steps_per_epoch * batch, batch):
            if order is not None:
                tr.sel.copy_(order[lo : lo + batch])
            if tr.graph is None and dev.type == "cuda" and steps == _WARM_STEPS:
                tr.capture()
            tr.step()
            steps += 1
        epochs = epoch + 1
        if epoch % 10 == 9:
            # the epoch mean of the batch losses, summed as Python floats
            losses = tr.losses.tolist()
            cur = sum(losses) / len(losses)
            if abs(prev_loss - cur) < 1e-6:
                break
            prev_loss = cur

    # fold the constraints into the stored tables: decode always uses the
    # same constrained lattice it was trained with
    emit, trans, start = tr.tables()
    tagger = _TrainedCRFTagger(
        emit=emit,
        trans=trans,
        start=start,
        tag_names=tuple(tag_names),
        hash_dim=hash_dim,
        kind="ner" if feature_fn is _emit_ner_features else "pos",
        device=None if device is None else str(device),
    )
    tagger.__dict__["fit_stats"] = {
        "sentences": n, "lmax": lmax, "batch": batch, "epochs": epochs, "steps": steps,
        "encode_s": encode_s, "train_s": time.perf_counter() - t_train,
        "graph": tr.graph is not None, "capture_s": tr.capture_s,
    }
    return tagger


# ---------------------------------------------------------------------------
# User-facing nodes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class CRFTaggerEstimator(Estimator):
    """fit(Dataset of (tokens, tags) sentences) -> CRF POS tagger, trained
    on ``device`` (``None`` means ``cuda``). The result plugs into
    ``POSTagger`` as an ``annotator=``."""

    n_epochs: int = 200
    lr: float = 0.1
    hash_dim: int = 1 << 17
    l2: float = 1e-5
    seed: int = 0
    batch_size: int = 1024
    device: Optional[Union[str, torch.device]] = None

    def fit(self, data: Dataset) -> "_TrainedCRFTagger":
        sentences = [(list(t), list(g)) for t, g in data.items()]
        return _fit_crf(
            sentences, _emit_features, self.hash_dim, self.n_epochs,
            self.lr, self.l2, self.seed, self.batch_size,
            constrain_bio=False, device=self.device,
        )


@dataclasses.dataclass(eq=False)
class CRFNEREstimator(Estimator):
    """fit(Dataset of (tokens, bio_tags) sentences) -> CRF NER tagger,
    trained on ``device`` (``None`` means ``cuda``). With
    ``constrain_bio`` (default), BIO validity is enforced in the lattice
    itself: training normalizes over valid paths only and decode cannot
    emit an invalid span."""

    n_epochs: int = 200
    lr: float = 0.1
    hash_dim: int = 1 << 17
    l2: float = 1e-5
    seed: int = 0
    batch_size: int = 1024
    constrain_bio: bool = True
    device: Optional[Union[str, torch.device]] = None

    def fit(self, data: Dataset) -> "_TrainedCRFTagger":
        sentences = [(list(t), list(g)) for t, g in data.items()]
        return _fit_crf(
            sentences, _emit_ner_features, self.hash_dim, self.n_epochs,
            self.lr, self.l2, self.seed, self.batch_size,
            constrain_bio=self.constrain_bio, device=self.device,
        )


@dataclasses.dataclass(eq=False)
class _TrainedCRFTagger(Transformer):
    """tokens -> (token, tag) pairs by exact Viterbi decode on ``device``
    (``None`` means ``cuda``). Also usable directly as a
    ``POSTagger``/``NER`` ``annotator=`` via ``__call__``. Parameters are
    plain numpy so the node pickles; constraint masks are pre-folded into
    trans/start."""

    emit: np.ndarray
    trans: np.ndarray
    start: np.ndarray
    tag_names: Tuple[str, ...]
    hash_dim: int
    kind: str = "pos"  # picks the feature fn; keeps pickling trivial
    device: Optional[str] = None

    def _feature_fn(self):
        return _emit_ner_features if self.kind == "ner" else _emit_features

    def _tables(self):
        """Device copies of the weight tables, made on first use.
        Non-field state: dropped from pickles (__getstate__)."""
        cached = self.__dict__.get("_tables_cache")
        if cached is None:
            dev = resolve_device(self.device)
            cached = tuple(torch.as_tensor(a, device=dev)
                           for a in (self.emit, self.trans, self.start))
            self.__dict__["_tables_cache"] = cached
        return cached

    def __getstate__(self):
        state = dict(self.__dict__)
        for key in ("_tables_cache", "_arr_digest_cache", "fit_stats"):
            state.pop(key, None)
        return state

    def decode(self, sentences: Sequence[Sequence[str]]) -> List[List[str]]:
        """Tags of each sentence; the sentences of one ``_bucket`` length
        are decoded together in one batched pass."""
        out: List[List[str]] = [[] for _ in sentences]
        live = [i for i, s in enumerate(sentences) if len(s) > 0]
        if not live:
            return out
        emit, trans, start = self._tables()
        encoded = _encode_many([sentences[i] for i in live], self._feature_fn(), self.hash_dim)
        groups = {}
        for i, enc in zip(live, encoded):
            groups.setdefault(_bucket(len(enc)), []).append((i, enc))
        k = encoded[0].shape[1]
        for pad, members in sorted(groups.items()):
            idx = np.zeros((len(members), pad, k), np.int32)
            lengths = np.empty(len(members), np.int64)
            for r, (_, enc) in enumerate(members):
                idx[r, : len(enc)] = enc
                lengths[r] = len(enc)
            with torch.no_grad():
                e = _emissions(emit, torch.as_tensor(idx, device=emit.device))
                paths = _viterbi_paths(e, trans, start, torch.as_tensor(lengths, device=emit.device))
            for r, (i, enc) in enumerate(members):
                out[i] = [self.tag_names[j] for j in paths[r, : len(enc)]]
        return out

    def __call__(self, tokens: Sequence[str]) -> List[str]:
        return self.decode([tokens])[0]

    def apply(self, tokens: Sequence[str]):
        return list(zip(tokens, self(tokens)))

    def apply_batch(self, ds: Dataset) -> Dataset:
        sentences = [list(t) for t in ds.items()]
        return Dataset.from_items(
            [list(zip(t, tags)) for t, tags in zip(sentences, self.decode(sentences))]
        )
