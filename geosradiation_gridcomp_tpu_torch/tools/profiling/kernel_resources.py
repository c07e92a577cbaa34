"""Registers, spills, shared memory and SASS instruction counts of the
port's kernels, for reading a kernel's design off its machine code.

    python -m geosradiation_gridcomp_tpu_torch.tools.profiling.kernel_resources \
        [--tree PATH] [--label NAME] [--threefry] [SOURCE ...]

Compiles each source (default: spcvmc.cu taumol_lw.cu) from the csrc/ of
the checkout at --tree (default: this one) with the port's nvcc flags and
-Xptxas -v, prints ptxas's lines for each kernel, and from
`cuobjdump -sass` counts each kernel's instructions, its MUFU
instructions (exp2, reciprocal, square root and the like) and, for each
loop (a branch back to an earlier address), the instructions of its body
by the class of pipe that executes them (PIPE_CLASSES). Prints one JSON
line per source. With --threefry it also prints the instructions of one
threefry draw of K1, K2 and K7's generator (threefry_counts). Needs the
CUDA toolkit.
"""

import argparse
import json
import os
import re
import shutil
import subprocess
import tempfile

from ...kernels import build

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BRA = re.compile(r"\bBRA\s+(?:`?\(?)0x([0-9a-f]+)")


def demangle(names):
    tool = shutil.which("c++filt") or shutil.which("cu++filt")
    if tool is None:
        return list(names)
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True).stdout.splitlines()
    return out if len(out) == len(names) else list(names)


def sass_functions(text):
    """{kernel: [(address, instruction)]} from cuobjdump -sass output."""
    funcs, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            cur = funcs.setdefault(line.split("Function :")[1].strip(), [])
        elif cur is not None:
            m = _INSN.search(line)
            if m:
                cur.append((int(m.group(1), 16), m.group(2)))
    return funcs


def is_mufu(insn):
    return re.search(r"(^|\s)MUFU\.", insn) is not None


# The class of each SASS instruction by the pipe of an SM sub-partition
# that executes it: alu (integer add, logic, shift, compare, select: IADD3,
# LOP3, SHF, ISETP, SEL, ...), imad (integer multiply-add, on the heavy half
# of the FMA pipe), fp32 (FFMA, FADD, FMUL), mufu, mem (loads, stores,
# atomics), ctrl (branches, barriers) and uniform (the per-warp U* ops).
PIPE_CLASSES = ("alu", "imad", "fp32", "mufu", "mem", "ctrl", "uniform")
_CTRL = {"BRA", "EXIT", "BAR", "BSSY", "BSYNC", "WARPSYNC", "NOP", "RET",
         "CALL", "YIELD", "BREAK", "BPT"}


def pipe_class(insn):
    """PIPE_CLASSES entry of one SASS instruction (predicate dropped)."""
    words = insn.split()
    op = (words[1] if words[0].startswith("@") else words[0]).split(".")[0]
    if op == "MUFU":
        return "mufu"
    if op in ("IMAD", "IMUL", "IDP"):
        return "imad"
    if op in ("FFMA", "FADD", "FMUL"):
        return "fp32"
    if op.startswith(("LD", "ST", "ATOM", "RED")):
        return "mem"
    if op in _CTRL:
        return "ctrl"
    if op.startswith("U"):
        return "uniform"
    return "alu"


def by_class(insns):
    counts = dict.fromkeys(PIPE_CLASSES, 0)
    for insn in insns:
        counts[pipe_class(insn)] += 1
    return counts


def summary(insns):
    """Instruction and MUFU counts of a kernel and of each loop body."""
    loops = []
    for addr, insn in insns:
        m = _BRA.search(insn)
        if m and int(m.group(1), 16) < addr:
            lo = int(m.group(1), 16)
            body = [i for a, i in insns if lo <= a <= addr]
            loops.append(dict(start=hex(lo), end=hex(addr), insns=len(body),
                              mufu=sum(map(is_mufu, body)),
                              pipes=by_class(body)))
    return dict(insns=len(insns), mufu=sum(is_mufu(i) for _, i in insns),
                loops=sorted(loops, key=lambda x: -x["insns"]))


def resources(path, workdir):
    """ptxas's lines and the SASS summary of each kernel of one source."""
    obj = os.path.join(workdir, os.path.basename(path) + ".o")
    res = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas",
                          "-v", "-I", os.path.dirname(path), "-c", "-o", obj,
                          path],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {path}:\n{res.stderr[-4000:]}")
    ptxas = [ln.strip() for ln in res.stderr.splitlines()
             if re.search(r"registers|spill|Compiling entry", ln)]
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", obj], capture_output=True,
                          text=True, check=True).stdout
    funcs = sass_functions(sass)
    names = demangle(list(funcs))
    return ptxas, {n: summary(i) for n, i in zip(names, funcs.values())}


# One (D = 1) or two (D = 2) threefry draws with their unit_float per
# iteration of a loop that is not unrolled, on loop-invariant keys as in
# K1's layer loop: the difference of the two loop bodies is one draw.
_THREEFRY_PROBE = r"""
#include "mcica_gen.cuh"
using namespace geosrad;
template <int D>
__global__ void threefry_probe(const uint32_t* keys, uint32_t* out, int n) {
    const uint32_t k0 = keys[0], k1 = keys[1];
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    const uint32_t base = static_cast<uint32_t>(t) * n;
    uint32_t acc = 0;
#pragma unroll 1
    for (int i = 0; i < n; i += D) {
#pragma unroll
        for (int d = 0; d < D; ++d)
            acc ^= __float_as_uint(unit_float(threefry_bits(k0, k1,
                                                            base + i + d)));
    }
    out[t] = acc;
}
template __global__ void threefry_probe<1>(const uint32_t*, uint32_t*, int);
template __global__ void threefry_probe<2>(const uint32_t*, uint32_t*, int);
"""


def threefry_counts(csrc=build.CSRC):
    """SASS instructions of one threefry draw (threefry_bits and
    unit_float of csrc/mcica_gen.cuh, plus the xor that keeps it live),
    by PIPE_CLASSES, as nvcc compiles them for the card."""
    with tempfile.TemporaryDirectory() as work:
        probe = os.path.join(work, "threefry_probe.cu")
        with open(probe, "w") as f:
            f.write(_THREEFRY_PROBE)
        shutil.copy(os.path.join(csrc, "mcica_gen.cuh"), work)
        shutil.copy(os.path.join(csrc, "common.cuh"), work)
        _, kernels = resources(probe, work)
    body = {}
    for name, s in kernels.items():
        d = 2 if "<2>" in name or "ILi2E" in name else 1
        if len(s["loops"]) != 1:
            raise RuntimeError(f"threefry probe {name}: expected one loop, "
                               f"found {len(s['loops'])}")
        body[d] = s["loops"][0]["pipes"]
    if set(body) != {1, 2}:
        raise RuntimeError(f"threefry probe: kernels {list(kernels)}")
    return {c: body[2][c] - body[1][c] for c in PIPE_CLASSES}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("sources", nargs="*",
                        default=["spcvmc.cu", "taumol_lw.cu"])
    parser.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        build.CSRC)))
    parser.add_argument("--label", default="")
    parser.add_argument("--threefry", action="store_true",
                        help="also count the instructions of one draw")
    args = parser.parse_args(argv)
    csrc = os.path.join(args.tree, "geosradiation_gridcomp_tpu_torch", "csrc")
    if args.threefry:
        print(json.dumps(dict(label=args.label,
                              threefry_draw=threefry_counts(csrc))))
    with tempfile.TemporaryDirectory() as work:
        for src in args.sources:
            ptxas, kernels = resources(os.path.join(csrc, src), work)
            print(f"== {args.label} {src}")
            for line in ptxas:
                print(f"  {line}")
            print(json.dumps(dict(label=args.label, source=src,
                                  kernels=kernels)))


if __name__ == "__main__":
    main()
