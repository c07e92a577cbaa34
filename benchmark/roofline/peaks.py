"""The H100 SXM's published peaks and the least time a count of work can
take on them.

NVIDIA's data sheet for the H100 SXM at its 700 W limit: 3.35 TB/s of
HBM3 and 67 TFLOP/s FP32 outside the tensor cores, an FMA counted as two
operations, on 132 SMs. That fixes the clock the peaks assume,
67e12 / (132 * 128 * 2) = 1.98 GHz. The CUDA C++ Programming Guide's
arithmetic-instruction throughputs for compute capability 9.0 give the
lanes per SM and clock: 128 FP32 (add, multiply, FMA), 64 for 32-bit
integer shifts, rotates (funnel shift) and logic, 16 for the special
function unit (exp2, log2, reciprocal, reciprocal square root), and each
of the four schedulers issues one warp instruction per clock, 128 lanes
in all.

A count is a dict of `bytes` (each input byte read once, each output
byte written once), `fp32` (FP32 instructions, an FMA one), `alu`
(integer instructions that only the ALU pipe runs: shifts, rotates,
logic), `iadd` (integer adds, which the compiler may also issue on the
FMA pipes) and `sfu` (special-function instructions). The least time is
the largest of what each limit allows; the share of a roofline is that
time over the measured time.
"""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
SMS = 132
CLOCK_HZ = FP32_FLOPS_PER_S / (SMS * 128 * 2)
FP32_PER_S = SMS * 128 * CLOCK_HZ
ALU_PER_S = SMS * 64 * CLOCK_HZ
SFU_PER_S = SMS * 16 * CLOCK_HZ
ISSUE_PER_S = SMS * 128 * CLOCK_HZ

# threefry2x32-20, per call (Salmon et al. 2011; the generator of
# jax.random that the McICA draws follow): 20 rounds of one add, one
# rotate and one xor; 5 key injections of two adds each (the round
# counter folded into the key word), 2 adds to inject the key first; the
# last round's add and the injection's merge into one three-input add,
# 5 times. Then per uniform: the xor of the two words, a shift and an or
# into the mantissa, and one FP32 subtract.
THREEFRY_ALU = 20 + 20
THREEFRY_IADD = 2 + 20 + 10 - 5
UNIFORM_ALU = 3
UNIFORM_FP32 = 1


def uniforms(n):
    """The count of n threefry uniforms."""
    return dict(alu=n * (THREEFRY_ALU + UNIFORM_ALU), iadd=n * THREEFRY_IADD,
                fp32=n * UNIFORM_FP32)


def add(*counts):
    out = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0.0) + float(v)
    return out


def least_seconds(count):
    """The least time the card can take for the count: the largest of
    its bytes over HBM bandwidth and its instructions over each limit."""
    get = count.get
    total = get("fp32", 0) + get("alu", 0) + get("iadd", 0) + get("sfu", 0)
    return max(get("bytes", 0) / HBM_BYTES_PER_S,
               get("fp32", 0) / FP32_PER_S, get("alu", 0) / ALU_PER_S,
               get("sfu", 0) / SFU_PER_S, total / ISSUE_PER_S)
