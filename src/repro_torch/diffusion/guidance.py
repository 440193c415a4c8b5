"""Guidance strategies and the reverse-process cores.

Every sampler is one ancestral/DDIM loop that differs only in how a step's
score ε̂ is formed: classifier-free (paper Eq. 8), classifier-guided (Eq. 4,
FedCADO's server side) or unconditional.  ``reverse_sample`` owns the
respacing, the step loop, the per-step noise draw and the update of a
uniform wave: the fused guidance-combine + ancestral update (the
``cfg_fuse`` kernel on CUDA) for classifier-free guidance, the plain
ancestral step for a strategy that forms ε̂ itself, as the JAX package
does.  The ragged cores give every row its own (guidance, steps) inside
one trajectory, right-aligned and frozen by an active mask until the row
starts: ``reverse_sample_ragged`` runs the whole wave,
``reverse_sample_compacted`` runs it as nested activation epochs
(``plan_epochs``) that skip frozen rows, and ``reverse_sample_window`` runs
one window of a wave against the wave-wide scalar table.  They update
through ``cfg_update_rowwise``.  The mixed cores (``reverse_sample_mixed``
and its window and segment forms) also give every row a guidance mode:
classifier-guided rows take the classifier correction of ``_clf_correct``
and the wave updates through ``cfg_update_mixed``.

Randomness comes from threefry keys (``repro_torch.prng``), drawn as the
JAX package draws them: a uniform wave splits its key for x_T and then
once per step; row b of a ragged wave draws x_T from
``fold_in(row_keys[b], 0)`` and its step-j noise from
``fold_in(row_keys[b], 1 + j)``, j the row's own step index.  On the card
the classifier-free updates of uniform and rowwise waves draw each step's
noise inside the fused update kernel from those keys; everywhere else
(the CPU, mixed waves, strategies that give no ε_u, injected noise) all of
a wave's noise is drawn in one vectorised call before its loop, the same
values.

Classifier gradients come from ``torch.autograd``.  Samplers that may take
one run under ``torch.no_grad()`` (no graph can be recorded on inference
tensors); the gradient is taken inside ``torch.enable_grad()`` on a
detached copy of x̂₀, in calls of one shape and with cuDNN held to
deterministic algorithms, so that the same key gives the same images
whatever wave a row rides in; the denoiser stays outside it.
"""
from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch import prng
from repro_torch.diffusion.dit import DiT
from repro_torch.diffusion.schedule import NoiseSchedule
from repro_torch.kernels.cfg_fuse import ops as cfg_ops
from repro_torch.kernels.cfg_fuse import ref as cfg_ref

# The reference's float32 linspace computes (T-1) * (1 - i * fl(1/div)),
# and XLA's CPU backend fuses ``1 - i * c`` into one rounding (FMA) only
# inside a vectorised loop body; elements outside it round twice.  How
# the loop vectorises depends on how the call was compiled.  Traced inside
# the jitted ``sample_cfg``, every element fuses from 17 elements on.
# Called eagerly, as the ragged engine's ``_respaced_ts_host`` calls it,
# only whole 32-lane chunks fuse, and only from 353 elements on.  Each
# mode is (the least length that fuses, the vector width).
_JIT_FUSION = (17, 1)
_EAGER_FUSION = (353, 32)


def _reference_linspace(start: int, num: int,
                        fusion: tuple[int, int] = _JIT_FUSION) -> np.ndarray:
    """``jnp.linspace(start, 0, num)`` in float32 as the reference evaluates
    it under ``fusion``.  Only its rounding at exact half-integers changes
    the rounded trajectory, and that depends on whether ``1 - i/div`` was
    rounded once or twice."""
    if num == 1:
        return np.array([start], np.float32)
    div = num - 1
    c = np.float32(1) / np.float32(div)
    i = np.arange(div)
    once = (1.0 - i * np.float64(c)).astype(np.float32)  # exact, then round
    twice = np.float32(1) - i.astype(np.float32) * c
    min_num, lanes = fusion
    fused = (div // lanes) * lanes if num >= min_num else 0
    frac = np.where(i < fused, once, twice)
    out = (np.float64(np.float32(start)) * frac).astype(np.float32)
    return np.concatenate([out, np.zeros(1, np.float32)])


def _strictly_decreasing(ts: np.ndarray) -> np.ndarray:
    """The tightest strictly decreasing integer envelope under ``ts`` that
    still ends at 0 (``cummin(ts + i) - i``, floored at ``num - 1 - i``):
    the identity on any already strictly decreasing trajectory."""
    n = len(ts)
    i = np.arange(n)
    ts = np.minimum.accumulate(ts + i) - i
    return np.maximum(ts, n - 1 - i)


def respaced_ts(T: int, num_steps: int, *, eager: bool = False
                ) -> torch.Tensor:
    """The respaced integer trajectory (num_steps,) from T-1 down to 0, on
    the CPU.  By default the timesteps the reference's jitted ``sample_cfg``
    visits; ``eager=True`` gives the reference's ``respaced_ts`` called
    eagerly, which its ragged tables use.  The two differ at some step
    counts, e.g. 19 and 27 at T = 1000."""
    if num_steps > T:
        raise ValueError(
            f"num_steps={num_steps} > T={T}: a respaced trajectory cannot "
            f"visit more distinct timesteps than the schedule has")
    lin = _reference_linspace(T - 1, num_steps,
                              _EAGER_FUSION if eager else _JIT_FUSION)
    return torch.from_numpy(_strictly_decreasing(
        np.round(lin).astype(np.int64)))


@functools.lru_cache(maxsize=512)
def _respaced_ts_host(T: int, k: int) -> np.ndarray:
    """The eager trajectory as int32 numpy, memoised per (T, k)."""
    return respaced_ts(T, k, eager=True).numpy().astype(np.int32)


def ancestral_coeffs(sched: NoiseSchedule, ts: torch.Tensor):
    """Per-step (ᾱ_t, ᾱ_prev) for the respaced trajectory."""
    ab = sched.alpha_bar
    ts = ts.to(ab.device)
    ab_t = ab[ts]
    ab_prev = torch.cat([ab[ts[1:]], torch.ones(1, device=ab.device)])
    return ab_t, ab_prev


@dataclass(frozen=True)
class ClassifierFree:
    """Paper Eq. 8: ε̂ = (1+s)·ε_θ(x,t,ȳ) − s·ε_θ(x,t,Ø), both score
    evaluations in ONE denoiser call (cond and uncond stacked on batch)."""
    y: torch.Tensor             # (B, cond_dim) encodings ȳ
    scale: float

    def batch(self) -> int:
        return self.y.shape[0]

    def prepare(self, model: DiT):
        return _with_null(model, self.y)

    def eps(self, model: DiT, x, t: int, ab_t: float, y2):
        B = x.shape[0]
        t2 = torch.full((2 * B,), t, dtype=torch.int64, device=x.device)
        eps2 = model(torch.cat([x, x], dim=0), t2, y2)
        return eps2[:B], eps2[B:], self.scale


@dataclass(frozen=True)
class ClassifierGuided:
    """Paper Eq. 4 (FedCADO): the unconditional score steered by the
    gradient of a client classifier's log p(y|x), taken at the clipped x̂₀
    and normalised per sample (``_guided_eps``)."""
    logprob_fn: Callable        # (x, labels) -> (B,) log p(y|x)
    labels: torch.Tensor        # (B,) integer labels
    scale: float

    def batch(self) -> int:
        return self.labels.shape[0]

    def prepare(self, model: DiT):
        return None

    def eps(self, model: DiT, x, t: int, ab_t: float, aux):
        B = x.shape[0]
        eps_u = model(x, torch.full((B,), t, dtype=torch.int64,
                                    device=x.device), None)
        # float32 per-row vectors, filled on the device (no host copy)
        ab = torch.full((B,), ab_t, dtype=torch.float32, device=x.device)
        scale = torch.full((B,), self.scale, dtype=torch.float32,
                           device=x.device)
        return _guided_eps(self.logprob_fn, x, eps_u, torch.sqrt(1.0 - ab),
                           torch.sqrt(ab), scale, self.labels), None, 0.0


@dataclass(frozen=True)
class Unconditional:
    """Plain p(x) sampling through the null embedding Ø (FedDISC-style
    draws without a steering signal)."""
    num: int

    def batch(self) -> int:
        return self.num

    def prepare(self, model: DiT):
        return None

    def eps(self, model: DiT, x, t: int, ab_t: float, aux):
        B = x.shape[0]
        return model(x, torch.full((B,), t, dtype=torch.int64,
                                   device=x.device), None), None, 0.0


def _with_null(model: DiT, y: torch.Tensor) -> torch.Tensor:
    """The stacked (2B, cond_dim) conditioning: y, then B null rows Ø."""
    null = model.null_y.expand(y.shape[0], model.dc.cond_dim)
    return torch.cat([y.float(), null], dim=0)


@contextlib.contextmanager
def _deterministic_cudnn():
    cudnn = torch.backends.cudnn
    prev = cudnn.deterministic
    cudnn.deterministic = True
    try:
        yield
    finally:
        cudnn.deterministic = prev


# rows per classifier call: see _logprob_grad
CLF_CHUNK = 128


def _logprob_grad(logprob_fn, x0, labels) -> torch.Tensor:
    """∇ Σ_b log p(labels_b | x̂₀_b) with respect to x̂₀ alone.

    The classifier runs on chunks of exactly ``CLF_CHUNK`` rows, the last
    one zero-padded.  cuDNN chooses its algorithms by batch size, so on the
    card a row's gradient would otherwise round differently with the number
    of rows that share the call; near a ReLU kink that flips a unit, and
    the early steps of a trajectory amplify the jump (on an H100 the
    classifier rows of a merged wave moved by up to 0.14 against the same
    rows served alone).  With one call shape a row's gradient does not
    depend on its wave."""
    n = x0.shape[0]
    grads = []
    for lo in range(0, n, CLF_CHUNK):
        z, lab = x0[lo:lo + CLF_CHUNK], labels[lo:lo + CLF_CHUNK]
        real = z.shape[0]
        if real < CLF_CHUNK:
            z = torch.cat([z, z.new_zeros((CLF_CHUNK - real, *z.shape[1:]))])
            lab = torch.cat([lab, lab.new_zeros(CLF_CHUNK - real)])
        with torch.enable_grad(), _deterministic_cudnn():
            z = z.detach().clone().requires_grad_(True)
            (grad,) = torch.autograd.grad(logprob_fn(z, lab).sum(), z)
        grads.append(grad[:real])
    return grads[0] if len(grads) == 1 else torch.cat(grads)


def _guided_eps(logprob_fn, x, eps_u, sqrt_1mab, sqrt_ab, scale, labels):
    """The stabilised Eq. 4 of the reference, per row: the classifier
    gradient at the clipped x̂₀, normalised per sample (norm floored at
    1e-6), scaled by s·√(1−ᾱ_t)·rms(ε_u) and taken from ε_u.  The scalars
    are per-row float32 tensors (n,)."""
    def r(v):
        return v.reshape((-1, 1, 1, 1))

    x0 = torch.clamp((x - r(sqrt_1mab) * eps_u) / r(sqrt_ab), -1.0, 1.0)
    grad = _logprob_grad(logprob_fn, x0, labels)
    gnorm = torch.sqrt(torch.sum(grad ** 2, dim=(1, 2, 3), keepdim=True))
    grad = grad / torch.clamp(gnorm, min=1e-6)
    enorm = torch.sqrt(torch.mean(eps_u ** 2, dim=(1, 2, 3), keepdim=True))
    return eps_u - r(scale) * r(sqrt_1mab) * grad * enorm


def reverse_sample(model: DiT, sched: NoiseSchedule, strategy, key=None, *,
                   image_size: int | None = None, channels: int = 3,
                   num_steps: int | None = None, eta: float = 1.0,
                   eager: bool = False, x_T: torch.Tensor | None = None,
                   noise=None):
    """The ancestral/DDIM loop (paper Eq. 9): x_T ~ N(0, I); at each
    respaced t the strategy gives (ε_c, ε_u, s) and the update advances
    x_t → x_{t−1}: the fused guidance update, or the plain ancestral step
    on ε_c when the strategy gives no ε_u.

    ``eager`` selects the respacing of the reference's eagerly called
    loop (its classifier-guided sampler is not jitted); the default is
    its jitted samplers' trajectory.  ``key`` (a threefry key) draws x_T
    from its first split and step i's noise from the chain of splits
    after it; on the card a classifier-free loop hands step i's key to
    the update kernel, which draws the noise itself.  ``x_T`` (B, H, W,
    C) and ``noise`` (num_steps, B, H, W, C) replace those draws when
    given; with both given ``key`` may be None."""
    B = strategy.batch()
    H = image_size or 16
    num_steps = num_steps or model.dc.sample_timesteps
    ts = respaced_ts(sched.T, num_steps, eager=eager)
    ab_t, ab_prev = ancestral_coeffs(sched, ts)
    steps = list(zip(ts.tolist(), ab_t.tolist(), ab_prev.tolist()))
    device = model.null_y.device
    shape = (B, H, H, channels)

    # the update kernel draws the noise on the card
    keyed = (noise is None and device.type == "cuda"
             and isinstance(strategy, ClassifierFree))
    if x_T is None or noise is None:
        if key is None:
            raise ValueError("reverse_sample needs a key unless both x_T "
                             "and noise are given")
        key, k0 = prng.split(key)
        step_keys = []
        for _ in range(num_steps):
            key, kn = prng.split(key)
            step_keys.append(kn)
        if keyed:
            x_T = prng.normal(k0, shape, device) if x_T is None else x_T
            step_keys = [(int(k[0]), int(k[1])) for k in step_keys]
        else:
            draws = prng.normal(np.stack([k0, *step_keys]), shape, device)
            x_T = draws[0] if x_T is None else x_T
            noise = draws[1:] if noise is None else noise
    x = x_T.to(device, torch.float32)
    aux = strategy.prepare(model)
    for i, (t, abt, abp) in enumerate(steps):
        eps_c, eps_u, s = strategy.eps(model, x, t, abt, aux)
        if keyed:
            x = cfg_ops.cfg_update(x, eps_c, eps_u, s, abt, abp, None, eta,
                                   noise_key=step_keys[i], live=t > 0)
            continue
        z = noise[i].to(device, torch.float32)
        if t == 0:
            z = torch.zeros_like(z)
        if eps_u is None:
            x = cfg_ref.ancestral_step(x, eps_c, abt, abp, z, eta)
        else:
            x = cfg_ops.cfg_update(x, eps_c, eps_u, s, abt, abp, z, eta)
    return torch.clamp(x, -1.0, 1.0)


# ---------------------------------------------------------------------------
# ragged mode: per-row (guidance, steps) inside one trajectory
# ---------------------------------------------------------------------------

def ragged_tables(sched: NoiseSchedule, steps, max_steps: int):
    """Right-aligned per-row respacing tables for a ragged wave.

    Row ``b`` with ``steps[b] = k`` runs its k-step trajectory (the eager
    one, as the reference's tables use) over the last k of ``max_steps``
    iterations, so every row ends on the same final iteration; before
    that it is frozen.  Returns ``(ts, ab_t, ab_prev, jloc)`` as
    (B, max_steps) numpy arrays; ``jloc[b, i] = i - (max_steps - k)`` is
    the row-local step index, negative while the row is frozen
    (``jloc >= 0`` is the active mask).  Frozen slots carry the row's first
    real (t, ᾱ) values, so the masked-out updates stay finite."""
    steps = np.asarray(steps, np.int32).reshape(-1)
    B, S = len(steps), int(max_steps)
    if steps.max(initial=1) > S:
        raise ValueError(f"max_steps={S} < largest row step count "
                         f"{int(steps.max())}")
    alpha_bar = np.asarray(sched.alpha_bar.detach().cpu(), np.float32)
    ts = np.zeros((B, S), np.int32)
    ab_t = np.zeros((B, S), np.float32)
    ab_prev = np.zeros((B, S), np.float32)
    jloc = np.arange(S, dtype=np.int32)[None] - (S - steps)[:, None]
    for k in np.unique(steps):
        rows = steps == k
        ts_k = _respaced_ts_host(sched.T, int(k))
        ab_k = alpha_bar[ts_k]
        abp_k = np.concatenate([ab_k[1:], np.ones((1,), np.float32)])
        ts[rows] = np.concatenate([np.full(S - k, ts_k[0], np.int32), ts_k])
        ab_t[rows] = np.concatenate([np.full(S - k, ab_k[0], np.float32),
                                     ab_k])
        ab_prev[rows] = np.concatenate([np.full(S - k, abp_k[0], np.float32),
                                        abp_k])
    return ts, ab_t, ab_prev, jloc


def _row_x_T(row_keys, shape, device) -> torch.Tensor:
    """x_T of each row, from ``fold_in(row_keys[b], 0)``: (B, *shape)."""
    return prng.normal(prng.fold_in(row_keys, 0), shape, device)


@dataclass(frozen=True)
class Mixed:
    """The per-row operands of a wave that mixes guidance modes: ``mode``
    (Bs,) spans the wave like the scalar table (0 classifier-free, with
    unconditional rows as its s = 0 point on a null condition; 1
    classifier-guided), ``clf_ids`` and ``labels`` (B,) belong to the rows
    the scan carries, and row b's classifier is ``clf_fns[clf_ids[b]]``."""
    mode: np.ndarray
    clf_ids: np.ndarray
    labels: np.ndarray
    clf_fns: tuple = ()

    @classmethod
    def of(cls, mode, clf_ids, labels, clf_fns=()) -> "Mixed":
        mode = np.asarray(mode, np.float32).reshape(-1)
        zeros = np.zeros(len(mode), np.int64)
        return cls(mode,
                   zeros if clf_ids is None else
                   np.asarray(clf_ids, np.int64).reshape(-1),
                   zeros if labels is None else
                   np.asarray(labels, np.int64).reshape(-1),
                   tuple(clf_fns))

    def rows(self, idx) -> "Mixed":
        """The operands of carried rows ``idx`` of a wave whose table is
        the wave's own (a compaction epoch)."""
        return Mixed(self.mode[idx], self.clf_ids[idx], self.labels[idx],
                     self.clf_fns)


def _clf_correct(eps_c, eps_u, x, coeffs, labels, groups):
    """Row-wise classifier correction (Eq. 4) of a mixed wave: the rows of
    each ``(fn, rows)`` in ``groups`` take ``_guided_eps`` of their own
    classifier, every other row keeps ε_c for the classifier-free combine.
    ``coeffs`` is the step's (9, B) table of these rows: √(1−ᾱ_t), √ᾱ_t and
    s per row.  The reference evaluates every classifier over the whole
    wave and selects per row; a classifier's value on a row depends only
    on that row, so evaluating it on its own rows gives the same values."""
    for fn, rows in groups:
        c = coeffs[:, rows]
        hat = _guided_eps(fn, x[rows], eps_u[rows], c[2], c[3], c[1],
                          labels[rows])
        eps_c = eps_c.index_copy(0, rows, hat)
    return eps_c


def _row_scan(model: DiT, x, y2, row_keys, guidance, ts, jloc, ab_t,
              ab_prev, active, *, row_offset: int, eta: float,
              mixed: Mixed | None = None):
    """The per-row reverse scan, one iteration per table column.

    ``x`` holds wave rows ``[row_offset, row_offset + B)``; ``y2``,
    ``row_keys`` and the ``ts``/``jloc`` tables (B, S) belong to those
    rows, while ``guidance`` (Bs,) and ``ab_t``/``ab_prev``/``active``
    (Bs, S) may span the whole wave: the fused update reads tensor row b's
    scalars at wave slot ``row_offset + b``.  Row b's step-j noise is
    ``fold_in(row_keys[b], max(j, 0) + 1)``, zero at t = 0: on the card
    the update kernel draws it from the (S, B) key table, uploaded once
    (on the CPU it is drawn before the loop).  The update coefficients
    are formed on the host and uploaded once.  With
    ``mixed`` the update is ``cfg_update_mixed`` and each iteration first
    corrects the active classifier-guided rows.  Returns x unclipped."""
    B, H, W, C = x.shape
    S = ts.shape[1]
    dev = x.device
    ts_steps = np.ascontiguousarray(ts.T)                    # (S, B)
    nk = prng.fold_in(np.asarray(row_keys)[None],
                      np.maximum(jloc.T, 0) + 1)             # (S, B, 2)
    live = torch.as_tensor(ts_steps > 0, device=dev).float()
    keyed = dev.type == "cuda"
    if keyed:
        keys = cfg_ops.key_table(nk, dev)
    else:
        noise = prng.normal(nk, (H, W, C), dev) * live[..., None, None, None]
    guidance = np.asarray(guidance, np.float32)
    if mixed is None:
        table = cfg_ops.rowwise_coeffs(guidance, ab_t.T, ab_prev.T, active.T,
                                       eta)
    else:
        table = cfg_ops.mixed_coeffs(mixed.mode, guidance, ab_t.T, ab_prev.T,
                                     active.T, eta)
        w = slice(row_offset, row_offset + B)
        is_clf = mixed.mode[w] >= 0.5
        labels = torch.as_tensor(mixed.labels, device=dev)
        row_sets: dict[bytes, torch.Tensor] = {}   # one upload per row set
    coeffs = torch.as_tensor(table, device=dev)
    t_all = torch.as_tensor(ts_steps, dtype=torch.int64, device=dev)
    for i in range(S):
        t2 = torch.cat([t_all[i], t_all[i]])
        eps2 = model(torch.cat([x, x], dim=0), t2, y2)
        eps_c, eps_u = eps2[:B], eps2[B:]
        if keyed:
            z, z_keys = None, dict(noise_keys=keys[i], live=live[i])
        else:
            z, z_keys = noise[i], {}
        if mixed is None:
            x = cfg_ops.cfg_update_rowwise(
                x, eps_c, eps_u, guidance, ab_t[:, i], ab_prev[:, i], z,
                active[:, i], eta, row_offset=row_offset, coeffs=coeffs[i],
                **z_keys)
            continue
        # frozen rows pass the update unchanged: only active classifier
        # rows need the gradient
        groups = []
        for k, fn in enumerate(mixed.clf_fns):
            rows = np.flatnonzero(is_clf & (active[w, i] > 0)
                                  & (mixed.clf_ids == k))
            if len(rows):
                rk = rows.tobytes()
                if rk not in row_sets:
                    row_sets[rk] = torch.as_tensor(rows, device=dev)
                groups.append((fn, row_sets[rk]))
        eps_c = _clf_correct(eps_c, eps_u, x, coeffs[i][:, w], labels,
                             groups)
        x = cfg_ops.cfg_update_mixed(
            x, eps_c, eps_u, mixed.mode, guidance, ab_t[:, i], ab_prev[:, i],
            z, active[:, i], eta, row_offset=row_offset, coeffs=coeffs[i],
            **z_keys)
    return x


def reverse_sample_ragged(model: DiT, y, row_keys, guidance, ts, ab_t,
                          ab_prev, jloc, *, image_size: int,
                          channels: int = 3, eta: float = 1.0):
    """Classifier-free reverse loop with per-row (guidance, steps):
    ``guidance`` (B,) and the (B, S) tables of ``ragged_tables``.  Each row
    draws its own noise from ``row_keys[b]``, so a row's result does not
    depend on the wave it is packed in."""
    return reverse_sample_mixed(model, y, row_keys, guidance, None, None,
                                None, ts, ab_t, ab_prev, jloc,
                                image_size=image_size, channels=channels,
                                eta=eta)


def reverse_sample_window(model: DiT, x, y, row_keys, guidance, ts, jloc,
                          ab_t, ab_prev, active, *, row_offset: int,
                          image_size: int, channels: int = 3,
                          eta: float = 1.0, mixed: Mixed | None = None):
    """One segment of one window of a wave: advance the carried rows ``x``
    and admit the rest.  ``y``, ``row_keys`` and ``ts``/``jloc`` belong to
    the window; ``guidance``, ``ab_t``, ``ab_prev`` and ``active`` span the
    whole wave and are read at slot ``row_offset + b``.  Admitted rows draw
    x_T from ``fold_in(row_keys[b], 0)``, as every other schedule draws it.
    Returns x unclipped."""
    n_prev = x.shape[0]
    x_new = _row_x_T(np.asarray(row_keys)[n_prev:],
                     (image_size, image_size, channels), y.device)
    x = torch.cat([x.to(y.device), x_new], dim=0)
    return _row_scan(model, x, _with_null(model, y), row_keys, guidance,
                     ts, jloc, ab_t, ab_prev, active, row_offset=row_offset,
                     eta=eta, mixed=mixed)


# ---------------------------------------------------------------------------
# mixed mode: classifier-free, classifier-guided and unconditional rows in
# one wave
# ---------------------------------------------------------------------------

def reverse_sample_mixed(model: DiT, y, row_keys, guidance, mode, clf_ids,
                         labels, ts, ab_t, ab_prev, jloc, *, clf_fns=(),
                         image_size: int, channels: int = 3,
                         eta: float = 1.0):
    """Reverse loop with per-row (mode, guidance, steps, classifier).
    ``y`` carries each row's condition: its encoding for a classifier-free
    row, the null embedding Ø for classifier-guided and unconditional
    rows.  Row noise is keyed as in ``reverse_sample_ragged``, so a row's
    value does not depend on which modes share its wave.  With ``mode``
    None the wave is classifier-free and updates through
    ``cfg_update_rowwise``."""
    mixed = None if mode is None else Mixed.of(mode, clf_ids, labels,
                                               clf_fns)
    x = _row_x_T(row_keys, (image_size, image_size, channels), y.device)
    x = _row_scan(model, x, _with_null(model, y), row_keys, guidance, ts,
                  jloc, ab_t, ab_prev, jloc >= 0, row_offset=0, eta=eta,
                  mixed=mixed)
    return torch.clamp(x, -1.0, 1.0)


def reverse_sample_mixed_window(model: DiT, x, y, row_keys, guidance, mode,
                                clf_ids, labels, ts, jloc, ab_t, ab_prev,
                                active, *, clf_fns=(), row_offset: int,
                                image_size: int, channels: int = 3,
                                eta: float = 1.0):
    """``reverse_sample_window`` for a mixed wave: ``mode`` spans the whole
    wave like ``guidance``; ``clf_ids`` and ``labels`` belong to the
    window.  Returns x unclipped."""
    mixed = Mixed.of(mode, clf_ids, labels, clf_fns)
    return reverse_sample_window(model, x, y, row_keys, guidance, ts, jloc,
                                 ab_t, ab_prev, active, row_offset=row_offset,
                                 image_size=image_size, channels=channels,
                                 eta=eta, mixed=mixed)


# ---------------------------------------------------------------------------
# compacted mode: iteration-compacted nested waves
# ---------------------------------------------------------------------------

def plan_epochs(steps, max_steps: int, *, compaction="full",
                granule: int = 1, geoms=None, compile_cost: int = 256):
    """Partition a ragged wave into activation epochs.

    Row b activates at iteration ``max_steps - steps[b]`` of the
    right-aligned scan.  Returns ``(order, epochs)``: ``order`` (B,) sorts
    rows by activation (stable, so the rows live in any epoch are a
    prefix of the sorted order), and ``epochs`` is a tuple of
    ``(rows, begin, end)``: iterations ``[begin, end)`` run over the first
    ``rows`` sorted rows.  The first epoch begins at the earliest start.

    ``compaction`` picks the boundaries: ``"full"`` one at every distinct
    start (no row ever rides frozen); an int K at most K, dropping the
    boundary whose removal adds the fewest frozen row-iterations; ``"auto"``
    one where the frozen row-iterations it saves outweigh ``compile_cost``,
    which is waived when the segment geometry ``(carried, rows, length)``
    is already in ``geoms``.  ``granule`` rounds each epoch's row count up;
    the extra rows are early arrivals, frozen until their start."""
    steps = np.asarray(steps, np.int32).reshape(-1)
    B, S = len(steps), int(max_steps)
    if B == 0:
        raise ValueError("plan_epochs: empty wave")
    if steps.min() < 1:
        raise ValueError(f"plan_epochs: step counts must be >= 1, got "
                         f"{int(steps.min())}")
    if steps.max() > S:
        raise ValueError(f"plan_epochs: max_steps={S} < largest row step "
                         f"count {int(steps.max())}")
    starts = S - steps
    order = np.argsort(starts, kind="stable")
    ss = starts[order]
    events = [(int(u), int(c)) for u, c in
              zip(*np.unique(ss, return_counts=True))]   # ascending starts

    def _rounded(rows):
        return min(-(-rows // granule) * granule, B) if granule > 1 else rows

    if compaction == "full":
        bounds = [u for u, _ in events]
    elif isinstance(compaction, int) and not isinstance(compaction, bool):
        if compaction < 1:
            raise ValueError(f"plan_epochs: K={compaction} < 1")
        bounds = [u for u, _ in events]
        while len(bounds) > compaction:
            costs = []
            for i in range(1, len(bounds)):
                hi = bounds[i + 1] if i + 1 < len(bounds) else S
                arriving = sum(c for u, c in events if bounds[i] <= u < hi)
                costs.append((arriving * (bounds[i] - bounds[i - 1]), i))
            bounds.pop(min(costs)[1])
    elif compaction == "auto":
        geoms = geoms or set()
        bounds = [events[0][0]]
        live = events[0][1]
        carried = 0        # rows the would-be segment inherits
        for u, c in events[1:]:
            length = u - bounds[-1]
            cut_cost = (0 if (carried, _rounded(live), length) in geoms
                        else int(compile_cost))
            if c * length >= cut_cost:
                bounds.append(u)
                carried = _rounded(live)
            live += c
    else:
        raise ValueError(f"plan_epochs: unknown compaction={compaction!r} "
                         f"(expected 'full', 'auto', or an int K)")

    epochs = []
    for i, b0 in enumerate(bounds):
        b1 = bounds[i + 1] if i + 1 < len(bounds) else S
        rows = _rounded(int(np.searchsorted(ss, b1, side="left")))
        epochs.append((rows, b0, b1))
    return order, tuple(epochs)


def reverse_sample_segment(model: DiT, x, y, row_keys, guidance, ts, ab_t,
                           ab_prev, jloc, *, image_size: int,
                           channels: int = 3, eta: float = 1.0,
                           mixed: Mixed | None = None):
    """One compaction epoch: advance the carried rows and admit the new
    ones (x_T from ``fold_in(row_keys[b], 0)``, the draw the one-shot
    ragged scan makes).  Tables are the ``[:rows, begin:end]`` slices of
    the wave's ``ragged_tables``.  Returns x unclipped."""
    return reverse_sample_window(model, x, y, row_keys, guidance, ts, jloc,
                                 ab_t, ab_prev, jloc >= 0, row_offset=0,
                                 image_size=image_size, channels=channels,
                                 eta=eta, mixed=mixed)


def reverse_sample_mixed_segment(model: DiT, x, y, row_keys, guidance, ts,
                                 ab_t, ab_prev, jloc, *, mode, clf_ids,
                                 labels, clf_fns=(), image_size: int,
                                 channels: int = 3, eta: float = 1.0):
    """One compaction epoch of a mixed wave: ``reverse_sample_segment`` with
    the epoch's rows' (mode, classifier, label) alongside.  Returns x
    unclipped."""
    return reverse_sample_segment(
        model, x, y, row_keys, guidance, ts, ab_t, ab_prev, jloc,
        image_size=image_size, channels=channels, eta=eta,
        mixed=Mixed.of(mode, clf_ids, labels, clf_fns))


def _check_plan(epochs, n_total: int, S: int, jloc) -> None:
    """Refuse a caller's plan that lacks the shape ``plan_epochs`` gives:
    contiguous non-empty epochs with nondecreasing row counts that run the
    tables to their end and compute every active (row, iteration)."""
    if not epochs:
        raise ValueError("reverse_sample_compacted: empty epoch plan")
    if epochs[-1][0] != n_total:
        raise ValueError(
            f"epochs cover {epochs[-1][0]} rows; wave has {n_total}")
    if epochs[0][1] < 0:
        raise ValueError(f"reverse_sample_compacted: epoch begins at "
                         f"iteration {epochs[0][1]} < 0")
    prev_end, prev_rows = epochs[0][1], 1
    for rows, begin, end in epochs:
        if begin != prev_end or end <= begin or not (prev_rows <= rows
                                                     <= n_total):
            raise ValueError(
                f"reverse_sample_compacted: malformed epoch "
                f"({rows}, {begin}, {end}) — epochs must be contiguous, "
                f"non-empty, with nondecreasing row counts")
        prev_end, prev_rows = end, rows
    if prev_end != S:
        raise ValueError(
            f"reverse_sample_compacted: epochs stop at iteration "
            f"{prev_end}; tables span {S}")
    b0 = epochs[0][1]
    if b0 > 0 and not (jloc[:, b0 - 1] < 0).all():
        raise ValueError(
            f"reverse_sample_compacted: rows are active before the first "
            f"epoch (begin {b0}) — their leading iterations would be "
            f"skipped")
    for rows, begin, end in epochs:
        if rows < n_total and not (jloc[rows:, end - 1] < 0).all():
            raise ValueError(
                f"reverse_sample_compacted: epoch ({rows}, {begin}, {end}) "
                f"excludes rows that are active within it")


def reverse_sample_compacted(model: DiT, y, row_keys, guidance, ts, ab_t,
                             ab_prev, jloc, *, epochs, order=None,
                             image_size: int, channels: int = 3,
                             eta: float = 1.0, mode=None, clf_ids=None,
                             labels=None, clf_fns=()):
    """Compute-skipping ragged reverse process: one scan segment per epoch
    of ``plan_epochs``, each over only the rows live by its end, stitched
    back into request order (``order`` from ``plan_epochs``; ``None`` if
    the inputs are already activation-sorted).  Same per-row arithmetic
    and noise as ``reverse_sample_ragged``; only the batches change.

    With ``mode`` (and ``clf_ids``, ``labels``, ``clf_fns``) the wave is a
    mixed one: its per-row operands are permuted by ``order`` and sliced
    per epoch with every other row vector."""
    row_keys = np.asarray(row_keys)
    guidance = np.asarray(guidance, np.float32)
    mixed = None if mode is None else Mixed.of(mode, clf_ids, labels,
                                               clf_fns)
    if order is not None:
        idx = np.asarray(order)
        y = y[torch.as_tensor(idx, device=y.device)]
        row_keys, guidance = row_keys[idx], guidance[idx]
        ts, ab_t, ab_prev, jloc = ts[idx], ab_t[idx], ab_prev[idx], jloc[idx]
        if mixed is not None:
            mixed = mixed.rows(idx)
    _check_plan(epochs, y.shape[0], ts.shape[1], np.asarray(jloc))
    H = image_size
    x = torch.zeros((0, H, H, channels), device=y.device)
    for rows, begin, end in epochs:
        x = reverse_sample_segment(
            model, x, y[:rows], row_keys[:rows], guidance[:rows],
            ts[:rows, begin:end], ab_t[:rows, begin:end],
            ab_prev[:rows, begin:end], jloc[:rows, begin:end],
            image_size=H, channels=channels, eta=eta,
            mixed=None if mixed is None else mixed.rows(slice(0, rows)))
    x = torch.clamp(x, -1.0, 1.0)
    if order is not None:
        inv = np.empty_like(idx)
        inv[idx] = np.arange(len(idx))
        x = x[torch.as_tensor(inv, device=x.device)]
    return x
