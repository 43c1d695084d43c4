"""The roofline kernel's instruction-level bound (run on the card).

``roofline_chain`` (``lumfuncmcmc_tpu_torch/csrc/roofline.cu``) iterates
``chain`` (``roofline.cu:16-24``) in registers. Its FMA-peak bound in
``chip_smoke.py`` counts 26 float32 operations per element and iteration,
each accurate ``expf``/``logf`` and the IEEE divide as one FMA. This tool
counts what the card executes instead: it builds the kernels, disassembles
``roofline_chain_kernel`` with ``cuobjdump -sass``, finds the loop that
iterates ``chain`` (the backward branch; the compiler may unroll it, and
its ``MUFU.RSQ`` count says by how much: one ``rsqrtf`` a ``chain``),
and counts its instructions by pipe:

- ``fp32``: ``FFMA``/``FADD``/``FMUL`` (128 results a clock an SM);
- ``mufu``: the special-function unit (16 a clock an SM);
- ``alu``: compares, selects, min/max, integer and logic (64);
- ``conv``: integer-float conversions (16);
- ``other``: moves, constant loads, branches and the rest (issue slots
  only).

Rates per SM and clock are the CUDA C++ Programming Guide's arithmetic
throughput table for compute capability 9.0; every SM issues 4 warp
instructions (128 thread instructions) a clock. The bound for
``rows x cols`` elements and ``iters`` iterations is the slowest of the
issue and the pipes at the card's maximum SM clock (``nvidia-smi
--query-gpu=clocks.max.sm``) over its SMs, beside the FMA-peak bound and
the kernel's own time (CUDA events, best of ``--reps``, this run).

    python3 tools/roofline_sass.py [--rows 256 --cols 1024 --iters 512]

Prints the counts, the SASS of the loop (``--show``) and one JSON line;
writes ``chiprun_out/roofline_sass.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

KERNEL = "roofline_chain_kernel"
RATES = {"fp32": 128, "mufu": 16, "alu": 64, "conv": 16}   # / clock / SM
CLASSES = (*RATES, "other")
ISSUE = 128                 # thread instructions / clock / SM
FP32 = {"FFMA", "FADD", "FMUL", "FFMA32I", "FADD32I", "FMUL32I"}
ALU = {"FMNMX", "FSETP", "FSEL", "FCHK", "ISETP", "IADD3", "IMAD", "LOP3",
       "SHF", "SEL", "IMNMX", "LEA", "FRND", "P2R", "R2P", "PLOP3", "IABS",
       "VIADD", "VIMNMX"}
CONV = {"I2F", "F2I", "I2FP", "F2IP", "F2F"}
FMA_BOUND_OPS = 26          # chip_smoke.py OPS["roofline_chain"]
PEAK_F32_OPS = 67e12


def _cuobjdump() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "cuobjdump")):
            return os.path.join(root, "bin", "cuobjdump")
    path = shutil.which("cuobjdump")
    if path is None:
        raise SystemExit("cuobjdump not found (set CUDA_HOME)")
    return path


def kernel_sass(lib: str) -> list:
    """``(address, opcode, text, branch target or None)`` of every
    instruction of the kernel's SASS (``cuobjdump`` writes branch targets
    as addresses)."""
    out = subprocess.run([_cuobjdump(), "-sass", lib], capture_output=True,
                         text=True, check=True).stdout
    body, inside = [], False
    for line in out.splitlines():
        if "Function :" in line:
            inside = KERNEL in line
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if inside and m:
            text = m.group(2).strip()
            op = re.sub(r"^@!?U?P[T\d]+\s+", "", text).split()[0]
            tgt = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", text)
            body.append((int(m.group(1), 16), op.split(".")[0], text,
                         int(tgt.group(1), 16) if tgt else None))
    if not body:
        raise SystemExit(f"no {KERNEL} in {lib}")
    return body


def chain_loop(body):
    """The instructions of the loop that iterates ``chain``: the range
    from a backward branch's target to the branch, the one holding the
    most ``MUFU.RSQ``. A forward branch that skips a ``CALL`` (the IEEE
    divide's slow path, taken only when ``FCHK`` flags a special case,
    never for these inputs) drops the skipped instructions."""
    best = None
    for addr, op, _, tgt in body:
        if op != "BRA" or tgt is None or tgt > addr:
            continue
        loop = [x for x in body if tgt <= x[0] <= addr]
        nrsq = sum(1 for x in loop if "MUFU.RSQ" in x[2])
        if best is None or nrsq > best[0]:
            best = (nrsq, loop)
    if best is None:
        raise SystemExit(f"no loop found in {KERNEL}")
    loop = best[1]
    skip = set()
    for addr, op, _, tgt in loop:
        if op == "BRA" and tgt is not None and tgt > addr:
            inner = [x for x in loop if addr < x[0] < tgt]
            if any(x[1] == "CALL" for x in inner):
                skip.update(x[0] for x in inner)
    return [x for x in loop if x[0] not in skip], len(skip)


def classify(op: str) -> str:
    if op == "MUFU":
        return "mufu"
    if op in FP32:
        return "fp32"
    if op in ALU:
        return "alu"
    if op in CONV:
        return "conv"
    return "other"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=256)
    ap.add_argument("--cols", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=512)
    ap.add_argument("--reps", type=int, default=12)
    ap.add_argument("--show", action="store_true",
                    help="print the loop's SASS")
    args = ap.parse_args(argv)

    import torch
    from lumfuncmcmc_tpu_torch.ops import _build
    from lumfuncmcmc_tpu_torch.ops import roofline as rl
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    lib = _build.build()
    loop, slow = chain_loop(kernel_sass(lib))
    counts = {k: 0 for k in CLASSES}
    by_op = {}
    for _, op, text, _ in loop:
        counts[classify(op)] += 1
        tok = re.sub(r"^@!?U?P[T\d]+\s+", "", text).split()[0]
        key = tok if op == "MUFU" else op
        by_op[key] = by_op.get(key, 0) + 1
    unroll = by_op.get("MUFU.RSQ", 0)
    if unroll < 1:
        raise SystemExit(f"no MUFU.RSQ in the loop: {by_op}")
    per_chain = {k: v / unroll for k, v in counts.items()}
    total = sum(per_chain.values())
    if args.show:
        for addr, _, text, _ in loop:
            print(f"    /*{addr:04x}*/ {text}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name, plimit, fmax = [x.strip() for x in smi.split(",")]
    f = float(fmax) * 1e6
    nsm = torch.cuda.get_device_properties(0).multi_processor_count
    threads = args.rows * args.cols * args.iters
    t_issue = total * threads / (ISSUE * nsm * f)
    t_pipe = {k: per_chain[k] * threads / (RATES[k] * nsm * f)
              for k in RATES}
    bound = max(t_issue, *t_pipe.values())
    by = max([("issue", t_issue)] + list(t_pipe.items()),
             key=lambda kv: kv[1])[0]
    t_fma = FMA_BOUND_OPS * threads / PEAK_F32_OPS

    gen = torch.Generator(device="cpu").manual_seed(0)
    x = (0.05 + 0.9 * torch.rand((args.rows, args.cols),
                                 generator=gen)).to("cuda")
    t_kernel = rl._timed_run(x, args.iters, args.reps)
    res = {
        "device": name, "power_limit_w": float(plimit),
        "sm_clock_max_mhz": float(fmax), "sms": nsm, "unroll": unroll,
        "loop_instructions": len(loop), "slow_path_skipped": slow,
        "per_chain": per_chain,
        "per_chain_total": total, "loop_opcodes": by_op,
        "elements": args.rows * args.cols, "iters": args.iters,
        "issue_us": t_issue * 1e6,
        "pipe_us": {k: v * 1e6 for k, v in t_pipe.items()},
        "bound_us": bound * 1e6, "bound_by": by,
        "fma_peak_bound_us": t_fma * 1e6, "kernel_us": t_kernel * 1e6,
        "kernel_over_bound": t_kernel / bound,
        "reaches_half_of_bound": bool(t_kernel <= 2 * bound),
    }
    print(f"{KERNEL} on {name} ({plimit} W, {nsm} SMs, max SM clock "
          f"{fmax} MHz): the loop holds {len(loop)} instructions, {unroll} "
          f"chain(s) a pass; per chain {total:g} instructions: "
          + ", ".join(f"{k} {v:g}" for k, v in per_chain.items()))
    print(f"{args.rows} x {args.cols} elements x {args.iters} iterations: "
          f"issue {t_issue * 1e6:.2f} us, "
          + ", ".join(f"{k} pipe {v * 1e6:.2f} us" for k, v in t_pipe.items())
          + f" -> bound {bound * 1e6:.2f} us ({by}); FMA-peak bound "
          f"{t_fma * 1e6:.2f} us; kernel {t_kernel * 1e6:.2f} us "
          f"({t_kernel / bound:.2f}x the bound)")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "roofline_sass.json"),
              "w") as fh:
        json.dump(res, fh, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
