"""Hold the wgmma attention kernels without positions against another
commit's build of them, on the card.

    git archive PARENT | tar -x -C _archive/parent
    python3 scripts/compare_attention_builds.py --parent _archive/parent

Builds the other tree's ``flash_attention_wgmma.cu`` and
``flash_attention_bwd_wgmma.cu`` with this tree's ``nvcc`` flags (into
``kernels/build/other/``), and then:

1. compares the SASS of each kernel build that both trees have (``fa_wgmma``
   at D 64 and 128 with and without L, ``fa_bwd_dq_wgmma`` and
   ``fa_bwd_dkdv_wgmma`` at D 64 and 128; here the builds without
   positions), instruction by instruction, where ``cuobjdump`` is found;
2. runs ``fa_wgmma`` at the Qwen3-8B prefill shape (B=4, H=32, Hkv=8,
   S=2048, D=128, causal), without and with L, and ``fa_bwd_wgmma`` at
   stablelm-1.6b's training shape (B=8, H=32, S=2048, D=64, causal) given
   that L, through both libraries on the same inputs, and requires equal
   bits;
3. times both builds of each in turns (other, this, this, other; each the
   mean of 10 calls under ``chip_smoke.Timer``) and prints the ratios
   beside the card's name and power limit.

The other tree's launch functions take the arguments they took before
positions were added (no position arguments); this tree's are called with
null positions.  Exits nonzero where bits differ or a build fails.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SOURCES = ("flash_attention_wgmma", "flash_attention_bwd_wgmma")
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# the launch functions as they were before they took positions
OTHER_SIGNATURES = {
    "flash_attention_wgmma_launch": [_P] * 5 + [_I] * 5 + [_L] * 12
    + [_F, _I, _I, _P],
    "flash_attention_bwd_wgmma_launch": [_P] * 10 + [_I] * 6
    + [_P, _F, _I, _I, _P]}


def build_other(tree: Path) -> dict:
    """{source: loaded library} of the other tree's builds."""
    from repro_torch.kernels import _build

    out_dir = _build.BUILD_DIR / "other"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
        src = tree / "src/repro_torch/kernels/csrc" / f"{name}.cu"
        lib = out_dir / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc(), *_build._flags(name), "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the other tree's {name}.cu:\n"
                               f"{log}")
        libs[name] = ctypes.CDLL(str(lib))
        fn = f"{name}_launch"
        getattr(libs[name], fn).argtypes = OTHER_SIGNATURES[fn]
        getattr(libs[name], fn).restype = _I
    return libs


def sass(lib: Path) -> dict:
    """{demangled kernel: [instructions, addresses and encodings dropped]}
    of a library, from ``cuobjdump -sass``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    kernels, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = subprocess.run(["c++filt", m.group(1)], capture_output=True,
                                  text=True).stdout.strip() or m.group(1)
            kernels[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
        if m and name:
            kernels[name].append(m.group(1).strip())
    return kernels


def key(name: str):
    """(kernel, its template arguments without the flags added since) of
    a demangled name, so that ``fa_wgmma<128, false>`` and ``fa_wgmma<128,
    false, false>`` pair up; None for a build with one of them set."""
    m = re.search(r"(fa_\w+)<([^>]*)>", name)
    if not m:
        return None
    args = [a.strip() for a in m.group(2).split(",")]
    kernel = m.group(1)
    n_other = 2 if kernel == "fa_wgmma" else 1
    if any(x != "false" for x in args[n_other:]):
        return None  # a build with positions (or a split dK/dV kernel)
    return kernel, tuple(args[:n_other])


def compare_sass(libs_new: dict, libs_other: dict) -> bool:
    same = True
    for name in SOURCES:
        new = {key(k): v for k, v in sass(libs_new[name]).items() if key(k)}
        other = {key(k): v for k, v in sass(libs_other[name]).items()
                 if key(k)}
        for k in sorted(other):
            if k not in new:
                print(f"sass {name} {k}: missing from this tree's build")
                same = False
                continue
            a, b = other[k], new[k]
            diff = sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
            print(f"sass {name} {k[0]}<{', '.join(k[1])}>: {len(b)} "
                  f"instructions here, {len(a)} in the other build, "
                  f"{diff} differ")
            same &= diff == 0
    return same


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", required=True, type=Path,
                        help="root of the other tree (e.g. unpacked by git "
                             "archive)")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("compare_attention_builds: no CUDA device", file=sys.stderr)
        sys.exit(1)
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    other = build_other(args.parent)
    _build.build(SOURCES)
    new_paths = {n: _build.library_path(n) for n in SOURCES}
    try:
        same_sass = compare_sass(new_paths, {
            n: _build.BUILD_DIR / "other" / f"lib{n}.so" for n in SOURCES})
    except (OSError, subprocess.CalledProcessError) as e:
        same_sass = None
        print(f"sass: not compared ({e})")

    gen = torch.Generator(device="cuda").manual_seed(27)
    B, H, Hkv, S, D = cs.QWEN_PREFILL.values()
    q, k, v = cs.flash_inputs(torch, gen, B, H, Hkv, S, D, "bfloat16")

    def fwd_other(with_lse):
        out = torch.empty((B, S, H, D), dtype=q.dtype, device="cuda")
        lse = (torch.empty((B, H, fa._lse_rows(S)), dtype=torch.float32,
                           device="cuda") if with_lse else None)
        (qsb, qsh, qss), (ksb, ksh, kss), (vsb, vsh, vss) = map(
            fa._strides, (q, k, v))
        status = other["flash_attention_wgmma"].flash_attention_wgmma_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), B, H, H // Hkv, S, D,
            qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, out.stride(0),
            out.stride(2), out.stride(1), fa._scale(D, None), 1, 0,
            _build.stream_ptr(q.device))
        _build.check_status("other fa_wgmma", status)
        out = out.permute(0, 2, 1, 3)
        return out if lse is None else (out, lse[..., :S])

    equal = {}
    equal["fa_wgmma"] = torch.equal(fwd_other(False),
                                    fa.flash_attention(q, k, v))
    o_other, l_other = fwd_other(True)
    o_new, l_new = fa.flash_attention_with_lse(q, k, v)
    equal["fa_wgmma L build"] = (torch.equal(o_other, o_new)
                                 and torch.equal(l_other, l_new))

    B2, H2, Hkv2, S2, D2 = cs.STABLELM_TRAIN.values()
    q2, k2, v2 = cs.flash_inputs(torch, gen, B2, H2, Hkv2, S2, D2, "bfloat16")
    do2 = cs.flash_inputs(torch, gen, B2, H2, H2, S2, D2, "bfloat16")[0]
    o2, l2 = fa.flash_attention_with_lse(q2, k2, v2)
    lse2 = fa._lse_arg(l2, B2, H2, S2)

    def bwd_other():
        dq, dk, dv = (torch.empty((B2, S2, h, D2), dtype=q2.dtype,
                                  device="cuda").permute(0, 2, 1, 3)
                      for h in (H2, Hkv2, Hkv2))
        strides = (ctypes.c_longlong * 24)(*(
            st for t in (q2, k2, v2, o2, do2, dq, dk, dv)
            for st in fa._strides(t)))
        delta = torch.empty((B2, H2, fa._lse_rows(S2)), dtype=torch.float32,
                            device="cuda")
        status = other["flash_attention_bwd_wgmma"]\
            .flash_attention_bwd_wgmma_launch(
                *(t.data_ptr() for t in (q2, k2, v2, o2, do2, dq, dk, dv)),
                lse2.data_ptr(), delta.data_ptr(), B2, H2, H2 // Hkv2, S2,
                fa._lse_rows(S2), D2, strides, fa._scale(D2, None), 1, 0,
                _build.stream_ptr(q2.device))
        _build.check_status("other fa_bwd_wgmma", status)
        return dq, dk, dv

    new_bwd = lambda: fa.flash_attention_bwd(  # noqa: E731
        q2, k2, v2, o2, do2, lse=l2)
    equal["fa_bwd_wgmma"] = all(torch.equal(a, b) for a, b in
                                zip(bwd_other(), new_bwd()))
    torch.cuda.synchronize()

    timer = cs.Timer(torch)
    rows = {"fa_wgmma": (lambda: fwd_other(False),
                         lambda: fa.flash_attention(q, k, v)),
            "fa_wgmma L build": (lambda: fwd_other(True),
                                 lambda: fa.flash_attention_with_lse(q, k, v)),
            "fa_bwd_wgmma": (bwd_other, new_bwd)}
    for name, (f_other, f_new) in rows.items():
        runs = {"other": [], "this": []}
        for which in ("other", "this", "this", "other"):
            fn = f_other if which == "other" else f_new
            runs[which].append(timer.ms(fn, iters=10))
        mean = {w: sum(r) / 2 for w, r in runs.items()}
        print(f"{name}: bit-equal {equal[name]}; this tree "
              f"{mean['this']:.6g} ms (runs {runs['this']}), the other "
              f"{mean['other']:.6g} ms (runs {runs['other']}), ratio "
              f"{mean['this'] / mean['other']:.4f} [{card}]")
    print(f"sass identical: {same_sass}")
    if not all(equal.values()):
        sys.exit(1)


if __name__ == "__main__":
    main()
