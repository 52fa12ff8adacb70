"""``jax.random.normal(jax.random.PRNGKey(seed), (n,), dtype)`` without JAX.

The JAX package starts the CG-Lanczos eigenvalue estimate of every
gather-engine level from that draw; this module computes the same vector
without JAX, bit for bit against JAX 0.9 on an x86-64 CPU in float64,
float32 and bfloat16 (``tests/test_torch_threefry.py``).  The bits and the
uniform's mantissas are NumPy on the host; the float arithmetic runs in
torch on the caller's device, where each elementwise kernel rounds once,
so the card draws the CPU's bits.  Square roots and float64 logs, whose
torch kernels are not correctly rounded on the CPU, are taken on the host.

* Bits: threefry2x32 (``jax._src.prng.threefry2x32_p``, 20 rounds, key
  schedule with 0x1BD11BDA) in JAX's partitionable mode, the default since
  JAX 0.5 (``jax_threefry_partitionable``).  The key of ``PRNGKey(seed)``
  is ``(seed >> 32, seed & 0xFFFFFFFF)``; the counter of entry i is the
  64-bit index i split into its high and low words, and the two output
  words b1, b2 give ``b1 << 32 | b2`` for 64 bits, ``b1 ^ b2`` for 32 and
  its low bits for 16 and 8 (``_threefry_random_bits_partitionable``).
* Uniforms: ``jax._src.random._uniform`` step by step: mantissa bits OR-ed
  with the bits of 1.0, minus 1, times ``maxval - minval`` plus ``minval``,
  then ``max(minval, .)``.  bfloat16 draws 8 random bits (its mantissa has
  fewer than 8).
* Normals: ``_normal_real``, ``sqrt(2) * erf_inv(u)`` with u uniform on
  ``[nextafter(-1, 0), 1)``, and ``erf_inv`` as XLA lowers ``chlo.erf_inv``:
  Giles' single-precision polynomial (split at w = 5) or the three-branch
  double one (split at w = 6.25 and 16) in w = -log1p(-x*x).

What XLA's CPU backend does beyond the HLO, copied here:

* It contracts a multiply whose product has one use into the add that
  follows (LLVM's ``AllowFPOpFusion = Fast``), which makes every Horner
  step an FMA.  torch has no FMA: float64 builds it from Dekker's exact
  product, Knuth's exact sum and a sum rounded to odd (Boldo and
  Melquiond's emulated FMA); float32 rounds the exact float64 sum to odd
  and then to float32.  Both round a * b + c once.
* Its ``log1p`` (``ElementalIrEmitter::EmitLog1p``) is Cephes' rational
  function for |x| < sqrt(2) - 1 and ``log(1 + x)`` above; float64 takes
  libm's ``log`` there (Python's ``math.log``), float32 XLA's own Cephes
  ``logf`` polynomial.
* bfloat16 computes in float32 and rounds each operation's result to
  bfloat16 (round to nearest even); ``erf_inv`` is the float32 one,
  rounded once.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0: int, k1: int, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 with 20 rounds on uint32 counter words (x0, x1)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = x0 + np.uint32(ks[0])
    x1 = x1 + np.uint32(ks[1])
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 += x1
            x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
            x1 ^= x0
        # the schedule's sums in Python ints: NumPy warns on uint32 scalars
        x0 += np.uint32(ks[(i + 1) % 3])
        x1 += np.uint32((ks[(i + 2) % 3] + i + 1) & 0xFFFFFFFF)
    return x0, x1


def random_bits(seed: int, n: int, width: int) -> np.ndarray:
    """``jax.random.bits(PRNGKey(seed), (n,), uint<width>)``, width 8, 16,
    32 or 64."""
    if width not in (8, 16, 32, 64):
        raise ValueError(f"width must be 8, 16, 32 or 64, not {width}")
    idx = np.arange(n, dtype=np.uint64)
    b1, b2 = threefry2x32(
        (seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF,
        (idx >> np.uint64(32)).astype(np.uint32), idx.astype(np.uint32),
    )
    if width == 64:
        return (b1.astype(np.uint64) << np.uint64(32)) | b2
    b1 ^= b2
    return b1 if width == 32 else b1.astype({8: np.uint8, 16: np.uint16}[width])


# -- exact fused multiply-add on tensors -------------------------------------

def _two_sum(a, b):
    """(s, e): s = a + b rounded, e = a + b - s exactly (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _to_odd(s: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """s + e rounded to odd, for float64 s = round(s + e): toward zero, the
    last bit set where inexact."""
    bits = s.view(torch.int64)  # +1 moves away from zero in either sign
    inexact_even = (e != 0) & ((bits & 1) == 0)
    away = (e > 0) == (s > 0)
    return (bits + (inexact_even & away).long() - (inexact_even & ~away).long()).view(torch.float64)


def _split(a):
    c = 134217729.0 * a  # 2**27 + 1
    hi = c - (c - a)
    return hi, a - hi


def _fma64(a, b, c):
    """round(a * b + c) in float64: the exact product p + e (Dekker), the
    exact sum s + f of p and c, then s + (e + f rounded to odd), which
    rounds once (Boldo and Melquiond, IEEE Trans. Comput. 57(4), 2008)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s, f = _two_sum(p, c)
    return s + _to_odd(*_two_sum(e, f))


def _fma32(a, b, c):
    """round(a * b + c) in float32: the product is exact in float64, the
    float64 sum is rounded to odd, which then rounds to float32 as the exact
    sum would."""
    p = a.double() * (b.double() if torch.is_tensor(b) else b)
    return _to_odd(*_two_sum(p, c.double() if torch.is_tensor(c) else c)).float()


def _horner(x, coeffs):
    """sum_k coeffs[k] x^(K-k), one FMA per step as XLA's CPU code runs it."""
    fma = _fma64 if x.dtype == torch.float64 else _fma32
    p = torch.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        p = fma(p, x, c)
    return p


def _in(dtype, values):
    """Python floats rounded to ``dtype``, the constants of XLA's code."""
    return [float(v) for v in torch.tensor(values, dtype=torch.float64).to(dtype)]


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to bfloat16 (round to nearest even), as float32."""
    return x.to(torch.bfloat16).float()


# -- log1p -------------------------------------------------------------------

# Cephes log1p rational function (XLA EmitLog1p), highest power first
_LOG1P_NUM = (4.52700008624452e-05, 0.49854102823193375, 6.578732594206104,
              29.911919328553072, 60.94966798098779, 57.11296359058554,
              20.039553499201283)
_LOG1P_DEN = (1.0, 15.062909083469192, 83.04756596796722, 221.76239823732857,
              309.09872225312057, 216.42788614495947, 60.11866049760384)
# Cephes logf polynomial (XLA's float32 log), highest power first, three
# interleaved chains of three
_LOGF = (0.07037683576345444, -0.11514610052108765, 0.11676998436450958,
         -0.12420140951871872, 0.14249323308467865, -0.16668057441711426,
         0.2000071406364441, -0.24999994039535522, 0.3333333134651184)


def _logf(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 natural log for positive finite x."""
    bits = x.clamp_min(torch.finfo(torch.float32).tiny).view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    low = m < _in(torch.float32, [0.7071067690849304])[0]
    e = e - low.float()
    x = (m - 1.0) + torch.where(low, m, 0.0)
    x2 = x * x
    x3 = x2 * x
    c = _in(torch.float32, _LOGF)
    y0 = _fma32(_fma32(x, c[0], c[1]), x, c[2])
    y1 = _fma32(_fma32(x, c[3], c[4]), x, c[5])
    y2 = _fma32(_fma32(x, c[6], c[7]), x, c[8])
    y = _fma32(_fma32(y0, x3, y1), x3, y2)
    y = _fma32(y, x3, e * _in(torch.float32, [-0.00021219444170128554])[0])
    return ((x - x2 * 0.5) + y) + e * 0.693359375


def _log1p(t: torch.Tensor) -> torch.Tensor:
    """XLA's log1p: the rational function everywhere, then ``log(1 + t)``
    copied in where |t| >= sqrt(2) - 1."""
    tsq = t * t
    ratio = _horner(t, _in(t.dtype, _LOG1P_NUM)) / _horner(t, _in(t.dtype, _LOG1P_DEN))
    out = t + (tsq * -0.5 + (t * tsq) * ratio)
    big = torch.nonzero(t.abs() >= _in(t.dtype, [0.41421356237309504880])[0]).squeeze(1)
    one_plus = t.index_select(0, big) + 1.0
    if t.dtype == torch.float64:
        # libm's log, as XLA's CPU code calls it, on the host
        logs = np.fromiter(map(math.log, one_plus.tolist()), np.float64, big.numel())
        return out.index_copy(0, big, torch.from_numpy(logs).to(t.device))
    return out.index_copy(0, big, _logf(one_plus))


# -- erf_inv -----------------------------------------------------------------

# Giles' polynomials, highest power first; (upper bound of w, shift of w or
# of sqrt(w), use sqrt(w), coefficients), in the order XLA selects them
_ERF_INV = {
    torch.float32: (
        (5.0, 2.5, False, (
            2.810226362726098e-08, 3.432739390518691e-07, -3.523387704262859e-06,
            -4.391506536194356e-06, 0.00021858086984138936, -0.001253725029528141,
            -0.004177681636065245, 0.24664072692394257, 1.5014094114303589)),
        (math.inf, 3.0, True, (
            -0.0002002142573473975, 0.0001009505576803349, 0.0013493432197719812,
            -0.003673428436741233, 0.005739507731050253, -0.007622461300343275,
            0.00943887047469616, 1.0016740560531616, 2.832976818084717)),
    ),
    torch.float64: (
        (6.25, 3.125, False, (
            -3.64441206401782e-21, -1.6850591381820166e-19, 1.28584807152564e-18,
            1.1157877678025181e-17, -1.333171662854621e-16, 2.0972767875968562e-17,
            6.637638134358324e-15, -4.054566272975207e-14, -8.151934197605472e-14,
            2.6335093153082323e-12, -1.2975133253453532e-11, -5.415412054294628e-11,
            1.0512122733215323e-09, -4.112633980346984e-09, -2.9070369957882005e-08,
            4.2347877827932404e-07, -1.3654692000834679e-06, -1.3882523362786469e-05,
            0.00018673420803405714, -0.000740702534166267, -0.006033670871430149,
            0.24015818242558962, 1.6536545626831027)),
        (16.0, 3.25, True, (
            2.2137376921775787e-09, 9.075656193888539e-08, -2.7517406297064545e-07,
            1.8239629214389228e-08, 1.5027403968909828e-06, -4.013867526981546e-06,
            2.9234449089955446e-06, 1.2475304481671779e-05, -4.7318229009055734e-05,
            6.828485145957318e-05, 2.4031110387097894e-05, -0.0003550375203628475,
            0.0009532893797373805, -0.0016882755560235047, 0.002491442096107851,
            -0.003751208507569241, 0.005370914553590064, 1.0052589676941592,
            3.0838856104922208)),
        (math.inf, 5.0, True, (
            -2.7109920616438573e-11, -2.555641816996525e-10, 1.5076572693500548e-09,
            -3.789465440126737e-09, 7.61570120807834e-09, -1.496002662714924e-08,
            2.914795345090108e-08, -6.771199775845234e-08, 2.2900482228026655e-07,
            -9.9298272942317e-07, 4.526062597223154e-06, -1.968177810553167e-05,
            7.599527703001776e-05, -0.00021503011930044477, -0.00013871931833623122,
            1.0103004648645344, 4.849906401408584)),
    ),
}


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's erf_inv on a float32 or float64 tensor: the first branch's
    polynomial everywhere, the others copied in where w reaches them."""
    w = -_log1p(-(x * x))
    (bound, shift, _, coeffs), *rest = _ERF_INV[x.dtype]
    out = _horner(w - shift, _in(x.dtype, coeffs)) * x
    beyond = torch.nonzero(w >= bound).squeeze(1)
    if beyond.numel():
        wb, xb = w.index_select(0, beyond), x.index_select(0, beyond)
        # NumPy's sqrt is correctly rounded, torch's CPU kernel is not
        root = torch.from_numpy(np.sqrt(wb.cpu().numpy())).to(x.device)
        vals = None
        for bound, shift, _, coeffs in reversed(rest):  # the last branch has no bound
            v = _horner(root - shift, _in(x.dtype, coeffs)) * xb
            vals = v if vals is None else torch.where(wb < bound, v, vals)
        out = out.index_copy(0, beyond, vals)
    return torch.where(x.abs() == 1.0, x * math.inf, out)


# -- draws -------------------------------------------------------------------

_CPU_BLOCK = 1 << 14  # under torch's grain size (32768): one thread per operation
_WIDTHS = {torch.float64: (64, 52, np.float64), torch.float32: (32, 23, np.float32),
           torch.bfloat16: (8, 7, np.float32)}


def _uniform(seed: int, n: int, dtype: torch.dtype, minval: float, maxval: float,
             device) -> torch.Tensor:
    """The uniform draw; bfloat16 as the float32 values of its results."""
    if dtype not in _WIDTHS:
        raise ValueError(f"no threefry draw for {dtype}")
    nbits, nmant, host = _WIDTHS[dtype]
    bits = random_bits(seed, n, nbits)
    if dtype == torch.bfloat16:  # 8 random bits over bfloat16's 7-bit mantissa
        bits = (bits.astype(np.uint32) >> np.uint32(1)) << np.uint32(16)
    else:
        bits = bits >> bits.dtype.type(nbits - nmant)
    f = (bits | np.array(1.0, host).view(bits.dtype)).view(host) - host(1)
    f = torch.from_numpy(f).to(device)
    if dtype == torch.bfloat16:
        lo, hi = _bf16(torch.tensor([minval, maxval])).tolist()
        scale = _bf16(torch.tensor(hi - lo)).item()
        return _bf16(_bf16(f * scale) + lo).clamp_min(lo)
    lo, hi = _in(dtype, [minval, maxval])
    scale = _in(dtype, [hi - lo])[0] if dtype == torch.float32 else hi - lo
    return (_fma64 if dtype == torch.float64 else _fma32)(f, scale, lo).clamp_min(lo)


def uniform(seed: int, n: int, dtype: torch.dtype = torch.float32,
            minval: float = 0.0, maxval: float = 1.0, device="cpu") -> torch.Tensor:
    """``jax.random.uniform(PRNGKey(seed), (n,), dtype, minval, maxval)``."""
    return _uniform(seed, n, dtype, minval, maxval, device).to(dtype)


def normal(seed: int, n: int, dtype: torch.dtype = torch.float32,
           device="cpu") -> torch.Tensor:
    """``jax.random.normal(PRNGKey(seed), (n,), dtype)`` as a tensor of
    ``dtype`` on ``device``.  A draw of n entries is the first n of any
    longer draw from the same seed."""
    u = _uniform(seed, n, dtype, -1.0 + torch.finfo(dtype).eps / 2, 1.0, device)  # nextafter(-1, 0)
    # on the CPU in blocks that one thread keeps in cache: ~70 elementwise
    # passes over the whole vector are slower, and more so on a busy host
    z = torch.cat([erf_inv(part) for part in u.split(n if u.is_cuda else _CPU_BLOCK)]) \
        if n else erf_inv(u)
    if dtype == torch.bfloat16:
        return (_bf16(z) * _bf16(torch.tensor(math.sqrt(2))).item()).to(dtype)
    return z * _in(dtype, [math.sqrt(2)])[0]
