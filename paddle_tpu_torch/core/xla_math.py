"""float32 ``log``, ``log1p``, ``erfinv``, ``exp`` and ``rsqrt`` as
XLA's CPU backend evaluates them for JAX, from correctly rounded
operations only.

The samplers of ``core/threefry.py`` turn threefry bits into floats
through these functions. ``torch.log`` and ``torch.erfinv`` round
differently from XLA's polynomials (and from each other on the CPU and
the GPU), so the port evaluates XLA's polynomials itself: the same
coefficients, the same order of operations, and a fused multiply-add
wherever XLA's code generator contracts a multiply into the add that
consumes it (:func:`fma`). Additions, multiplications, divisions and
square roots (:func:`sqrt`) are correctly rounded on both devices,
so a draw has the same bits on the CPU and the card, and the JAX
package's bits on the CPU.

Sources: XLA's CPU elemental emitter (the Cephes-derived ``log_f32``
and ``exp_f32``, ``EmitLog1p``'s rational approximation below
sqrt(2) - 1) and
StableHLO's ``erf_inv`` lowering (Giles' polynomials), as jax 0.9.0
compiles them.
"""

from __future__ import annotations

import math

import torch

_F32_MIN_NORMAL = 1.1754943508222875e-38
_SQRT_HALF = 0.7071067690849304

# log_f32: three interleaved polynomials in x, then combined in x^3
_LOG_A = (0.07037683576345444, -0.11514610052108765, 0.11676998436450958)
_LOG_B = (-0.12420140951871872, 0.14249323308467865, -0.16668057441711426)
_LOG_C = (0.2000071406364441, -0.24999994039535522, 0.3333333134651184)
_LOG_Q1 = -0.00021219444170128554
_LOG_Q2 = 0.693359375

# EmitLog1p's rational approximation for |x| < sqrt(2) - 1
_LOG1P_SMALL = 0.4142135679721832
_LOG1P_DEN = (1.0, 15.062909126281738, 83.04756927490234,
              221.7624053955078, 309.0987243652344, 216.42788696289062,
              60.11865997314453)
_LOG1P_NUM = (4.527000055531971e-05, 0.4985410273075104, 6.578732490539551,
              29.91191864013672, 60.949668884277344, 57.11296463012695,
              20.039552688598633)

# erf_inv: Giles' coefficients for w < 5 and for w >= 5
_ERFINV_LT5 = (2.810226362726098e-08, 3.432739390518691e-07,
               -3.523387704262859e-06, -4.391506536194356e-06,
               0.00021858086984138936, -0.001253725029528141,
               -0.004177681636065245, 0.24664072692394257,
               1.5014094114303589)
_ERFINV_GE5 = (-0.0002002142573473975, 0.0001009505576803349,
               0.0013493432197719812, -0.003673428436741233,
               0.005739507731050253, -0.007622461300343275,
               0.00943887047469616, 1.0016740560531616, 2.832976818084717)


def fma(a, b, c):
    """``a * b + c`` rounded once to float32: the exact product in
    float64, the sum rounded to float64 and then to float32 (double
    rounding differs from one rounding only when the float64 sum falls
    on a float32 midpoint)."""
    a = a.double() if isinstance(a, torch.Tensor) else a
    b = b.double() if isinstance(b, torch.Tensor) else b
    c = c.double() if isinstance(c, torch.Tensor) else c
    return (a * b + c).float()


def div(a, n):
    """``a / n`` for a Python number ``n``, divided as the CPU and XLA
    divide: given a Python divisor, CUDA multiplies by its reciprocal,
    which can differ in the last bit (a quantization scale an ulp off
    moves the weights on a rounding boundary; a sample coordinate of a
    few hundred pixels moves by its ulp)."""
    return a / torch.tensor(float(n), dtype=a.dtype, device=a.device)


def sqrt(x):
    """The correctly rounded float32 square root (torch's vectorized CPU
    ``sqrt`` is not, for some inputs), through float64."""
    return torch.sqrt(x.double()).float()


def log(x):
    """XLA's float32 natural log (denormal inputs read as zero, as XLA's
    CPU code flushes them)."""
    xc = torch.where(x > _F32_MIN_NORMAL, x,
                     torch.full_like(x, _F32_MIN_NORMAL))
    bits = xc.view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)
    small = m < _SQRT_HALF
    xm = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    e = e - small.to(torch.float32)
    z = xm * xm
    x3 = z * xm
    ya = fma(fma(xm, _LOG_A[0], _LOG_A[1]), xm, _LOG_A[2])
    yb = fma(fma(xm, _LOG_B[0], _LOG_B[1]), xm, _LOG_B[2])
    yc = fma(fma(xm, _LOG_C[0], _LOG_C[1]), xm, _LOG_C[2])
    y = fma(fma(ya, x3, yb), x3, yc)
    y = fma(y, x3, e * _LOG_Q1)
    out = fma(e, _LOG_Q2, fma(z, -0.5, xm) + y)
    out = torch.where(x < 0, torch.full_like(out, math.nan), out)
    out = torch.where((x >= 0) & (x < _F32_MIN_NORMAL),
                      torch.full_like(out, -math.inf), out)
    return torch.where(x == math.inf, x, out)


def log1p(x):
    """XLA's float32 ``log1p``: ``log(1 + x)``, and below ``sqrt(2) - 1``
    in magnitude a rational approximation."""
    large = log(x + 1.0)
    x2 = x * x
    zero = x * 0.0
    den = zero + _LOG1P_DEN[0]
    for c in _LOG1P_DEN[1:]:
        den = fma(den, x, c)
    num = zero + _LOG1P_NUM[0]
    for c in _LOG1P_NUM[1:]:
        num = fma(num, x, c)
    small = x + fma(x2, -0.5, (x * x2) * (num / den))
    return torch.where(torch.abs(x) < _LOG1P_SMALL, small, large)


def erfinv(x):
    """XLA's float32 ``erf_inv`` (Giles' single-precision polynomials)."""
    lg = log1p(x * -x)
    lt = lg > -5.0
    w = torch.where(lt, -2.5 - lg, sqrt(-lg) - 3.0)

    def coef(i):
        return torch.where(lt, torch.full_like(w, _ERFINV_LT5[i]),
                           torch.full_like(w, _ERFINV_GE5[i]))
    p = fma(coef(0), w, coef(1))
    for i in range(2, 9):
        p = fma(w, p, coef(i))
    p = torch.where(torch.abs(x) == 1.0, torch.full_like(p, math.inf), p)
    return x * p


# exp_f32: range reduction by ln 2 in two parts, then a degree-5
# polynomial
_EXP_LO, _EXP_HI = -87.80000305175781, 88.80000305175781
_LOG2E = 1.4426950216293335
_EXP_P = (0.00019875691214110702, 0.001398199936375022,
          0.008333452045917511, 0.04166579619050026, 0.1666666567325592,
          0.5)


def exp(x):
    """XLA's float32 ``exp`` (a denormal result flushed to zero, as XLA's
    CPU code does)."""
    xc = torch.clamp(x, _EXP_LO, _EXP_HI)
    n = torch.clamp(torch.floor(fma(xc, _LOG2E, 0.5)), -127.0, 127.0)
    r = fma(n, -_LOG_Q1, fma(n, -_LOG_Q2, xc))
    y = fma(r, _EXP_P[0], _EXP_P[1])
    for c in _EXP_P[2:]:
        y = fma(y, r, c)
    y = fma(y, r * r, r) + 1.0
    scale = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    out = y * scale
    out = torch.where(out < _F32_MIN_NORMAL, torch.zeros_like(out), out)
    return torch.where(torch.isnan(x), x, out)


def rsqrt(x):
    """XLA's float32 ``rsqrt``: a 12-bit estimate refined by two Newton
    steps. XLA starts from the x86 ``rsqrtss`` estimate, whose bits
    depend on the processor model; the port starts from the correctly
    rounded value cut to 12 bits, which gives XLA's result for most
    inputs (about 95% of a uniform sample) and the same result on the
    CPU and the card."""
    y = (1.0 / torch.sqrt(x.double())).float()
    y = (y.view(torch.int32) & ~0x7FF).view(torch.float32)
    for _ in range(2):
        t = fma(x * y, y, -1.0)
        y = fma(y * -0.5, t, y)
    return y
