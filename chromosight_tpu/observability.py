"""Tracing and per-stage timing.

The reference ships no profiling beyond a progress bar (SURVEY §5).  Here:

* ``stage(name)`` - context manager recording wall time per pipeline stage;
  a summary is printed on exit when CHROMOSIGHT_TPU_TIMINGS=1.
* ``maybe_trace(path)`` - wraps a block in ``jax.profiler.trace`` when
  CHROMOSIGHT_TPU_PROFILE=<dir> is set, producing TensorBoard-compatible
  device traces.
"""

from __future__ import annotations

import atexit
import os
import sys
import threading
import time
from collections import defaultdict
from contextlib import contextmanager

_STAGE_TOTALS = defaultdict(float)
_STAGE_COUNTS = defaultdict(int)
_BYTE_TOTALS = defaultdict(int)
# Per-program-family compute accounting (MFU / roofline): logical FLOPs
# and HBM-byte bounds, accumulated per dispatch (see account_dispatch).
_FLOP_TOTALS = defaultdict(float)
_HBM_MIN_TOTALS = defaultdict(float)
_HBM_UNFUSED_TOTALS = defaultdict(float)
_DISPATCH_COUNTS = defaultdict(int)
_COST_CACHE = {}
_ENABLED = os.environ.get("CHROMOSIGHT_TPU_TIMINGS", "") not in ("", "0")
# stages/bytes are recorded from worker threads too (prefetcher, tile
# dispatch pool, mesh host tails); += on a dict slot is not atomic
_LOCK = threading.Lock()


def add_bytes(channel, n):
    """Account bytes crossing the host<->device link (upload/download), so
    benchmarks can attribute link time = bytes / measured bandwidth even
    when transfers are enqueued asynchronously."""
    with _LOCK:
        _BYTE_TOTALS[channel] += int(n)


def snapshot():
    """(stage_totals, stage_counts, byte_totals) copies for benchmarks."""
    return dict(_STAGE_TOTALS), dict(_STAGE_COUNTS), dict(_BYTE_TOTALS)


def reset():
    """Clear accumulated stage and byte counters."""
    _STAGE_TOTALS.clear()
    _STAGE_COUNTS.clear()
    _BYTE_TOTALS.clear()
    _FLOP_TOTALS.clear()
    _HBM_MIN_TOTALS.clear()
    _HBM_UNFUSED_TOTALS.clear()
    _DISPATCH_COUNTS.clear()


def _arg_sig(x, keep_scalars=False):
    """Cache-key signature of one argument.

    Arrays key on (shape, dtype).  Bare positional ints/floats are
    DROPPED by default: at the instrumented sites those are traced
    scalars (logical row counts, max_dist, thresholds) whose value does
    not change the compiled program's cost — keying on them would
    re-trace once per chromosome.  Kwargs (where the jitted programs
    put their static parameters) keep scalars.
    """
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        return ("arr", tuple(x.shape), str(x.dtype))
    if isinstance(x, bool) or x is None or isinstance(x, str):
        return x
    if isinstance(x, (int, float)):
        return x if keep_scalars else ("scalar",)
    if isinstance(x, (tuple, list)):
        return tuple(_arg_sig(v, keep_scalars=True) for v in x)
    if isinstance(x, dict):
        return tuple(
            sorted((k, _arg_sig(v, keep_scalars=True)) for k, v in x.items())
        )
    return repr(x)


# Elementwise arithmetic (one FLOP per result element) and reductions
# (one per input element), as XLA's HloCostAnalysis counts them.
_ELEMENTWISE = frozenset(
    "add sub mul div rem max min neg abs sign floor ceil round sqrt rsqrt "
    "cbrt exp exp2 expm1 log log1p logistic tanh atanh sin cos tan atan2 "
    "pow integer_pow square erf erfc erf_inv".split()
)
_REDUCTIONS = frozenset(
    "reduce_sum reduce_max reduce_min reduce_prod argmax argmin cumsum "
    "cummax cummin cumprod cumlogsumexp".split()
)


def jaxpr_cost(jaxpr):
    """(FLOPs, bytes) of a jaxpr, each loop body times its trip count.

    FLOPs are arithmetic as written: one per result element of each
    elementwise op, one per input element of a reduction, 2*M*N*K per
    ``dot_general``, 2 x output x window x input features per
    ``conv_general_dilated``.  Bytes are every operation's operands plus
    results (a slice's result twice), intermediates included: the
    traffic of a program nothing fuses.  A ``scan`` (what ``fori_loop`` with static bounds becomes)
    counts ``length`` times its body, a ``while`` of unknown trip count
    once, a ``cond`` its costliest branch.  (XLA's cost analysis counts
    every while-loop body once, which undercounts the shift-FMA conv of
    ``ops.convolve`` by the kernel's height, and the GPU backend returns
    none for an unoptimized lowering.)"""
    import numpy as _np
    from jax.extend import core as jcore

    def size(v):
        return int(_np.prod(v.aval.shape, dtype=_np.int64))

    def nbytes(vs):
        return sum(size(v) * v.aval.dtype.itemsize for v in vs if hasattr(v.aval, "dtype"))

    def subjaxprs(params):
        for v in params.values():
            for x in v if isinstance(v, (tuple, list)) else (v,):
                if isinstance(x, jcore.ClosedJaxpr):
                    yield x.jaxpr
                elif isinstance(x, jcore.Jaxpr):
                    yield x

    flops = traffic = 0
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name == "scan":
            f, b = jaxpr_cost(eqn.params["jaxpr"].jaxpr)
            flops, traffic = flops + eqn.params["length"] * f, traffic + eqn.params["length"] * b
            continue
        if name == "cond":
            f, b = max(jaxpr_cost(br.jaxpr) for br in eqn.params["branches"])
            flops, traffic = flops + f, traffic + b
            continue
        subs = list(subjaxprs(eqn.params))
        if subs:  # calls and while loops: their bodies hold the work
            for sub in subs:
                f, b = jaxpr_cost(sub)
                flops, traffic = flops + f, traffic + b
            continue
        if name in ("slice", "dynamic_slice"):  # reads only what it keeps
            traffic += 2 * nbytes(eqn.outvars)
        else:
            traffic += nbytes(eqn.invars) + nbytes(eqn.outvars)
        if name in _ELEMENTWISE:
            flops += size(eqn.outvars[0])
        elif name in _REDUCTIONS:
            flops += size(eqn.invars[0])
        elif name == "dot_general":
            (contract, _), _batch = eqn.params["dimension_numbers"]
            lhs = eqn.invars[0].aval.shape
            k = int(_np.prod([lhs[d] for d in contract], dtype=_np.int64))
            flops += 2 * size(eqn.outvars[0]) * k
        elif name == "conv_general_dilated":
            rhs = eqn.invars[1].aval.shape
            spec = eqn.params["dimension_numbers"].rhs_spec
            window = int(_np.prod([rhs[d] for d in spec[1:]], dtype=_np.int64))
            flops += 2 * size(eqn.outvars[0]) * window
    return flops, traffic


def _program_cost(name, jitfn, args, kwargs):
    """(flops, hbm_min_bytes, hbm_unfused_bytes) per dispatch, cached per
    (program, shape signature), from :func:`jaxpr_cost` of the traced
    program (no lowering, no compile, no device traffic).

    * ``flops`` — logical FLOPs as written.  The band engine's matmuls
      run at precision=HIGHEST (full float32), so on a GPU they run
      outside the TF32 tensor-core path.
    * ``hbm_min_bytes`` — sum of input + output buffer sizes: the
      speed-of-light HBM traffic a perfectly fused executable would pay.
    * ``hbm_unfused_bytes`` — every operation's operands and results:
      the traffic if nothing fused.  True traffic lies in between.
    """
    key = (
        name,
        tuple(_arg_sig(a) for a in args),
        _arg_sig(kwargs, keep_scalars=True),
    )
    with _LOCK:
        hit = _COST_CACHE.get(key)
    if hit is not None:
        return hit
    flops = hbm_min = hbm_unfused = 0.0
    try:
        import jax.tree_util as jtu
        import numpy as _np

        closed = jitfn.trace(*args, **kwargs).jaxpr
        in_bytes = sum(
            x.dtype.itemsize * x.size
            for x in jtu.tree_leaves(args)
            if hasattr(x, "dtype") and hasattr(x, "size")
        )
        out_bytes = sum(
            x.dtype.itemsize * int(_np.prod(x.shape)) for x in closed.out_avals
        )
        hbm_min = float(in_bytes + out_bytes)
        flops, hbm_unfused = map(float, jaxpr_cost(closed.jaxpr))
    except Exception:
        pass  # cost accounting is best-effort; never break the dispatch
    cost = (flops, hbm_min, hbm_unfused)
    with _LOCK:
        _COST_CACHE[key] = cost
    return cost


def account_dispatch(name, jitfn, *args, **kwargs):
    """Record the compute cost of one dispatch of a jitted program.

    Call next to the actual dispatch with the same arguments; the cost
    is computed once per shape signature (host-side trace only) and
    accumulated under the program-family ``name``.
    """
    flops, hbm_min, hbm_unfused = _program_cost(name, jitfn, args, kwargs)
    with _LOCK:
        _FLOP_TOTALS[name] += flops
        _HBM_MIN_TOTALS[name] += hbm_min
        _HBM_UNFUSED_TOTALS[name] += hbm_unfused
        _DISPATCH_COUNTS[name] += 1


def compute_snapshot():
    """Per-program-family compute totals for benchmarks / rooflines.

    Returns a dict name -> {flops, hbm_min_bytes, hbm_unfused_bytes,
    dispatches}.
    """
    with _LOCK:
        return {
            name: {
                "flops": _FLOP_TOTALS[name],
                "hbm_min_bytes": _HBM_MIN_TOTALS[name],
                "hbm_unfused_bytes": _HBM_UNFUSED_TOTALS[name],
                "dispatches": _DISPATCH_COUNTS[name],
            }
            for name in _FLOP_TOTALS
        }


# Published dense peak rates, keyed by the exact ``device_kind`` JAX
# reports: FLOP/s per number format and device-memory bytes/s.
# Source: NVIDIA H100 Tensor Core GPU data sheet (SXM part, without
# sparsity), at its full 700 W power limit.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,
        "tf32_flops": 495e12,
        "fp32_flops": 67e12,
        "hbm_bytes": 3.35e12,
    },
}


def device_peaks():
    """Published peak rates of the current device (a dict with the
    ``DEVICE_PEAKS`` keys plus ``kind``), or None on the CPU, which has
    no peak worth normalising against.  An accelerator that is not in
    the table raises ``KeyError``: no rate is ever assumed."""
    import jax

    if jax.default_backend() == "cpu":
        return None
    kind = jax.devices()[0].device_kind
    if kind not in DEVICE_PEAKS:
        raise KeyError(f"no published peak rates for device kind {kind!r}")
    return dict(DEVICE_PEAKS[kind], kind=kind)


@contextmanager
def stage(name):
    """Accumulate wall-clock time for a named pipeline stage."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _LOCK:
            _STAGE_TOTALS[name] += dt
            _STAGE_COUNTS[name] += 1


def report(file=None):
    file = file or sys.stderr
    if not _STAGE_TOTALS:
        return
    file.write("\n-- chromosight-tpu stage timings --\n")
    for name, total in sorted(
        _STAGE_TOTALS.items(), key=lambda kv: -kv[1]
    ):
        file.write(
            f"  {name:<28} {total:8.3f}s  ({_STAGE_COUNTS[name]} calls)\n"
        )
    if _FLOP_TOTALS:
        file.write("-- compute accounting (per program family) --\n")
        for name, flops in sorted(
            _FLOP_TOTALS.items(), key=lambda kv: -kv[1]
        ):
            file.write(
                f"  {name:<28} {flops / 1e12:8.3f} TFLOP  "
                f"{_HBM_MIN_TOTALS[name] / 1e9:8.3f} GB io-min  "
                f"({_DISPATCH_COUNTS[name]} dispatches)\n"
            )


if _ENABLED:
    atexit.register(report)


@contextmanager
def maybe_trace():
    """Enable a jax profiler trace when CHROMOSIGHT_TPU_PROFILE is set."""
    trace_dir = os.environ.get("CHROMOSIGHT_TPU_PROFILE")
    if not trace_dir:
        yield
        return
    import jax

    with jax.profiler.trace(trace_dir):
        yield
