"""The roofline kernel's instruction-level bound (run on the card).

``roofline_chain`` (``lumfuncmcmc_tpu_torch/csrc/roofline.cu``) iterates
``chain`` (``roofline.cu:44-49``) in registers, E independent elements a
thread (``ROOFLINE_CHAINS``) in one loop. Its FMA-peak bound in
``chip_smoke.py`` counts 26 float32 operations per element and iteration,
each ``expf``, log and divide as one FMA. This tool counts what the card
executes instead: it disassembles ``roofline_chain_kernel`` with
``cuobjdump -sass``, finds the innermost loop that iterates ``chain`` (a
backward branch with no other loop inside it, the one with the most
``MUFU.RSQ``: one ``rsqrtf`` a chain, so their count is the chains a pass,
E times the compiler's unroll), and counts its instructions by pipe:

- ``fp32``: ``FFMA``/``FADD``/``FMUL`` (128 results a clock an SM);
- ``mufu``: the special-function unit (16 a clock an SM);
- ``alu``: compares, selects, min/max, integer and logic (64);
- ``conv``: integer-float conversions (16);
- ``other``: moves, constant loads, branches and the rest (issue slots
  only).

Rates per SM and clock are the CUDA C++ Programming Guide's arithmetic
throughput table for compute capability 9.0; every SM issues 4 warp
instructions (128 thread instructions) a clock. The bound for ``rows x
cols`` elements and ``iters`` iterations is the slowest of the issue and
the pipes over the card's SMs, at its maximum SM clock (``nvidia-smi
--query-gpu=clocks.max.sm``) and at the SM clock it sustains under this
kernel (``clocks.sm`` sampled every 100 ms by an ``nvidia-smi``
subprocess while back-to-back launches of ``--clock-iters`` iterations
keep the card busy for ``--clock-seconds``), beside the FMA-peak bound and
the kernel's own time (CUDA events, best of ``--reps``, this run).

``--chains 1,2,4`` also builds ``roofline.cu`` alone for each E
(``-DROOFLINE_CHAINS=E``) and ``--parent FILE`` an earlier ``roofline.cu``
as it is: each is counted the same way, held to the plain version after 8
iterations (rtol 1e-5) and timed at the same shape in turns with the
library's kernel (forward, then backward order; the best of each).

    python3 tools/roofline_sass.py [--rows 256 --cols 1024 --iters 512]
        [--chains 1,2,4] [--parent DIR/roofline.cu] [--show]

Prints the counts, the SASS of the loop (``--show``) and one JSON line;
writes ``chiprun_out/roofline_sass.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import re
import shutil
import statistics
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
OUT = os.path.join(ROOT, "chiprun_out")


def _cuda_tool(name: str) -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", name)):
            return os.path.join(root, "bin", name)
    path = shutil.which(name)
    if path is None:
        raise SystemExit(f"{name} not found (set CUDA_HOME)")
    return path


def kernel_sass(lib: str) -> list:
    """``(address, opcode, text, branch target or None)`` of every
    instruction of the kernel's SASS (``cuobjdump`` writes branch targets
    as addresses)."""
    out = subprocess.run([_cuda_tool("cuobjdump"), "-sass", lib],
                         capture_output=True, text=True, check=True).stdout
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
    """The instructions of the loop that iterates ``chain``: of the
    innermost loops (a backward branch's target to the branch, holding no
    other backward branch), the one with the most ``MUFU.RSQ``. A forward
    branch that skips a ``CALL`` (an IEEE divide's slow path, taken only
    when ``FCHK`` flags a special case, never for these inputs) drops the
    skipped instructions."""
    loops = [(tgt, addr) for addr, op, _, tgt in body
             if op == "BRA" and tgt is not None and tgt <= addr]
    inner = [(a, b) for a, b in loops
             if not any(a <= c and d <= b and (c, d) != (a, b)
                        for c, d in loops)]
    best = None
    for a, b in inner:
        loop = [x for x in body if a <= x[0] <= b]
        nrsq = sum(1 for x in loop if "MUFU.RSQ" in x[2])
        if best is None or nrsq > best[0]:
            best = (nrsq, loop)
    if best is None:
        raise SystemExit(f"no loop found in {KERNEL}")
    loop = best[1]
    skip = set()
    for addr, op, _, tgt in loop:
        if op == "BRA" and tgt is not None and tgt > addr:
            skipped = [x for x in loop if addr < x[0] < tgt]
            if any(x[1] == "CALL" for x in skipped):
                skip.update(x[0] for x in skipped)
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


def count(lib: str, show: bool = False) -> dict:
    """The chain loop's instructions of ``lib``'s kernel, a pass and a
    chain, by pipe and by opcode (``MUFU`` by function)."""
    loop, slow = chain_loop(kernel_sass(lib))
    counts = {k: 0 for k in CLASSES}
    by_op = {}
    for _, op, text, _ in loop:
        counts[classify(op)] += 1
        tok = re.sub(r"^@!?U?P[T\d]+\s+", "", text).split()[0]
        key = tok if op == "MUFU" else op
        by_op[key] = by_op.get(key, 0) + 1
    chains = by_op.get("MUFU.RSQ", 0)
    if chains < 1:
        raise SystemExit(f"no MUFU.RSQ in the loop: {by_op}")
    if show:
        for addr, _, text, _ in loop:
            print(f"    /*{addr:04x}*/ {text}")
    per_chain = {k: v / chains for k, v in counts.items()}
    return {"chains_per_pass": chains, "loop_instructions": len(loop),
            "slow_path_skipped": slow, "per_chain": per_chain,
            "per_chain_total": sum(per_chain.values()),
            "mufu_per_chain": {k[5:]: v / chains for k, v in by_op.items()
                               if k.startswith("MUFU.")},
            "loop_opcodes": by_op}


def bounds(per_chain: dict, threads: int, nsm: int, mhz: float) -> dict:
    """Issue and pipe times (us) of ``threads`` chain evaluations on
    ``nsm`` SMs at ``mhz``, and the slowest of them."""
    f = mhz * 1e6
    t = {"issue": sum(per_chain.values()) * threads / (ISSUE * nsm * f)}
    t.update({k: per_chain[k] * threads / (RATES[k] * nsm * f)
              for k in RATES})
    by = max(t, key=t.get)
    return {"us": {k: v * 1e6 for k, v in t.items()},
            "bound_us": t[by] * 1e6, "bound_by": by}


def build_variant(src: str, label: str, chains=None):
    """``src`` compiled alone into its own library beside the kernel
    library's build (``-DROOFLINE_CHAINS`` when ``chains`` is given);
    returns the path and the kernel's registers from ``-Xptxas -v``."""
    from lumfuncmcmc_tpu_torch.ops import _build
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    so = os.path.join(_build.BUILD_DIR, f"libroofline_{label}.so")
    flags = [f for f in _build.NVCC_FLAGS if f not in ("--threads", "0")]
    cmd = [_build.find_nvcc(), *flags, "-o", so, src]
    if chains is not None:
        cmd.insert(1, f"-DROOFLINE_CHAINS={chains}")
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {label}:\n{proc.stderr}")
    regs = re.findall(r"Used (\d+) registers", proc.stdout + proc.stderr)
    return so, int(regs[-1]) if regs else None


def launcher(lib):
    """``fn(x, out, iters)``: one ``roofline_chain_launch`` of ``lib`` (a
    loaded library or a path) on the current stream."""
    import torch
    if isinstance(lib, str):
        lib = ctypes.CDLL(lib)
        lib.roofline_chain_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        lib.roofline_chain_launch.restype = ctypes.c_int

    def fn(x, out, iters):
        rc = lib.roofline_chain_launch(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            x.numel(), int(iters),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if rc != 0:
            raise RuntimeError(f"roofline_chain launch failed: CUDA {rc}")
    return fn


def best_time(fn, x, iters, reps) -> float:
    """Best-of-``reps`` seconds of one launch, between CUDA events."""
    import torch
    out = torch.empty_like(x)
    fn(x, out, iters)
    best = math.inf
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(x, out, iters)
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b) * 1e-3)
    return best


def sustained_clock(fn, x, iters, seconds) -> dict:
    """``clocks.sm`` and ``power.draw`` sampled every 100 ms while
    back-to-back launches of ``iters`` iterations keep the card busy for
    about ``seconds`` (the first and last sample dropped: they may fall
    outside the load)."""
    import torch
    out = torch.empty_like(x)
    one = best_time(fn, x, iters, 2)
    n = max(1, math.ceil(seconds / one))
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        for _ in range(n):
            fn(x, out, iters)
        torch.cuda.synchronize()
    finally:
        proc.terminate()
        text = proc.communicate(timeout=30)[0]
    rows = []
    for line in text.splitlines():
        try:
            rows.append([float(v) for v in line.split(",")])
        except ValueError:
            continue
    rows = rows[1:-1]
    res = {"launches": n, "iters": iters, "load_s": n * one,
           "samples": len(rows)}
    if rows:
        mhz = [r[0] for r in rows]
        watts = [r[1] for r in rows]
        res.update({"sm_mhz_median": statistics.median(mhz),
                    "sm_mhz_min": min(mhz), "sm_mhz_max": max(mhz),
                    "power_w_median": statistics.median(watts)})
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=256)
    ap.add_argument("--cols", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=512)
    ap.add_argument("--reps", type=int, default=12)
    ap.add_argument("--clock-iters", type=int, default=65536)
    ap.add_argument("--clock-seconds", type=float, default=4.0)
    ap.add_argument("--chains", default="",
                    help="comma-separated E to build roofline.cu with")
    ap.add_argument("--parent", default=None,
                    help="an earlier roofline.cu to count and time")
    ap.add_argument("--show", action="store_true",
                    help="print the loop's SASS")
    args = ap.parse_args(argv)

    import torch
    from lumfuncmcmc_tpu_torch.ops import _build
    from lumfuncmcmc_tpu_torch.ops import roofline as rl
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name, plimit, fmax = [x.strip() for x in smi.split(",")]
    nsm = torch.cuda.get_device_properties(0).multi_processor_count
    nelem = args.rows * args.cols
    threads = nelem * args.iters
    gen = torch.Generator(device="cpu").manual_seed(0)
    x = (0.05 + 0.9 * torch.rand((args.rows, args.cols),
                                 generator=gen)).to("cuda")
    ref = rl.roofline_chain_reference(x, 8)

    lib = _build.build()
    lay = rl.kernel_layout(nelem)
    variants = {"library": {"lib": lib, "fn": launcher(_build.load_library()),
                            "chains": lay["chains_per_thread"],
                            "registers": lay["registers"], "layout": lay}}
    src = os.path.join(_build.SRC_DIR, "roofline.cu")
    for e in [int(v) for v in args.chains.split(",") if v.strip()]:
        so, regs = build_variant(src, f"E{e}", e)
        variants[f"E={e}"] = {"lib": so, "fn": launcher(so), "chains": e,
                              "registers": regs}
    if args.parent:
        so, regs = build_variant(os.path.abspath(args.parent), "parent")
        variants["parent"] = {"lib": so, "fn": launcher(so), "chains": 1,
                              "registers": regs}

    t_fma = FMA_BOUND_OPS * threads / PEAK_F32_OPS
    for label, v in variants.items():
        v.update(count(v["lib"], show=args.show and label == "library"))
        v["unroll"] = v["chains_per_pass"] / v["chains"]
        v["bounds_max_clock"] = bounds(v["per_chain"], threads, nsm,
                                       float(fmax))
        out = torch.empty_like(x)
        v["fn"](x, out, 8)
        torch.cuda.synchronize()
        v["max_rel_err_8"] = float(((out - ref).abs() / ref.abs()).max())
        if not v["max_rel_err_8"] <= 1e-5:
            raise SystemExit(f"{label}: kernel vs plain "
                             f"{v['max_rel_err_8']:.3e} > 1e-5")
    order = list(variants)
    times = {k: [] for k in order}
    for turn in (order, order[::-1]):
        for label in turn:
            times[label].append(best_time(variants[label]["fn"], x,
                                          args.iters, args.reps))
    clock = sustained_clock(variants["library"]["fn"], x, args.clock_iters,
                            args.clock_seconds)
    fsus = clock.get("sm_mhz_median")
    res = {"device": name, "power_limit_w": float(plimit),
           "sm_clock_max_mhz": float(fmax), "sms": nsm,
           "elements": nelem, "iters": args.iters,
           "fma_peak_bound_us": t_fma * 1e6, "sustained": clock,
           "variants": {}}
    print(f"{KERNEL} on {name} ({plimit} W, {nsm} SMs, max SM clock {fmax} "
          f"MHz; sustained {fsus} MHz median of {clock['samples']} samples "
          f"under {clock['load_s']:.2f} s of load, "
          f"{clock.get('sm_mhz_min')}-{clock.get('sm_mhz_max')}, "
          f"{clock.get('power_w_median')} W); {args.rows} x {args.cols} "
          f"elements x {args.iters} iterations, FMA-peak bound "
          f"{t_fma * 1e6:.2f} us")
    for label, v in variants.items():
        t = min(times[label])
        b = v["bounds_max_clock"]
        row = {k: v[k] for k in ("chains", "registers", "chains_per_pass",
                                 "unroll", "loop_instructions",
                                 "slow_path_skipped", "per_chain",
                                 "per_chain_total", "mufu_per_chain",
                                 "loop_opcodes", "max_rel_err_8")}
        row.update({"layout": v.get("layout"), "kernel_us": t * 1e6,
                    "kernel_us_turns": [s * 1e6 for s in times[label]],
                    "max_clock": b,
                    "kernel_over_bound": t * 1e6 / b["bound_us"]})
        if fsus:
            bs = bounds(v["per_chain"], threads, nsm, fsus)
            row["sustained_clock"] = bs
            row["kernel_over_sustained_bound"] = t * 1e6 / bs["bound_us"]
        res["variants"][label] = row
        print(f"[{label}] E = {v['chains']}, {v['registers']} registers; "
              f"the loop holds {v['loop_instructions']} instructions, "
              f"{v['chains_per_pass']} chains a pass (unroll "
              f"{v['unroll']:g}); per chain {v['per_chain_total']:g}: "
              + ", ".join(f"{k} {c:g}" for k, c in v["per_chain"].items())
              + "; MUFU " + ", ".join(f"{k} {c:g}" for k, c in
                                      v["mufu_per_chain"].items()))
        print(f"    at {fmax} MHz: "
              + ", ".join(f"{k} {c:.2f} us" for k, c in b["us"].items())
              + f" -> bound {b['bound_us']:.2f} us ({b['bound_by']})"
              + (f"; at {fsus:g} MHz: bound "
                 f"{row['sustained_clock']['bound_us']:.2f} us "
                 f"({row['sustained_clock']['bound_by']})" if fsus else "")
              + f"; kernel {t * 1e6:.2f} us (turns "
              + ", ".join(f"{s * 1e6:.2f}" for s in times[label])
              + f"), {row['kernel_over_bound']:.3f}x the bound at max clock"
              + (f", {row['kernel_over_sustained_bound']:.3f}x at the "
                 f"sustained clock" if fsus else "")
              + f"; vs plain after 8 iterations {v['max_rel_err_8']:.2e}")
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "roofline_sass.json"), "w") as fh:
        json.dump(res, fh, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
