"""Instructions of the port's CUDA kernels, read from their builds.

``ptxas_frames`` reads each kernel's registers, stack frame and spills from
nvcc's ``-Xptxas -v`` log (``cuda_build.BuiltLibrary.log``); the rest reads
the SASS (``cuobjdump -sass``) of a built library and counts the issued
instructions of a path kernel's substep loop (:class:`IssueSlots`), the
count behind the issue-slot times of ``chip_smoke.py`` and of the substep
ladder's decomposition (``tools/kernel_decomposition.py``), beside the
card's memory rate that both hold the kernels' byte bounds to.  Nothing runs
at import; cuobjdump runs only where a count is asked for.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess

# Issue slots: each of the 4 schedulers of each of the 132 SMs issues one
# warp instruction (32 lanes) per cycle.
ISSUE_LANES_PER_CYCLE = 132 * 4 * 32
HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM data sheet
# One of the 32-bit multiplies of a Philox round; ten of them are a call.
_PHILOX_MULTIPLY = re.compile(r"\bIMAD\.(WIDE|HI)\.U32\b")


def find_cuobjdump():
    """The toolkit's cuobjdump, else the copy in Triton's package; None if
    neither is there."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for path in (os.path.join(home, "bin", "cuobjdump"), shutil.which("cuobjdump"),
                 "/usr/local/cuda/bin/cuobjdump"):
        if path and os.access(path, os.X_OK):
            return path
    try:
        import triton

        path = os.path.join(os.path.dirname(triton.__file__), "backends", "nvidia", "bin",
                            "cuobjdump")
        return path if os.access(path, os.X_OK) else None
    except ImportError:
        return None


def sass_of(built) -> str:
    """cuobjdump -sass of a built kernel library ('' without cuobjdump)."""
    tool = find_cuobjdump()
    if tool is None:
        return ""
    return subprocess.run([tool, "-sass", str(built.path)], capture_output=True, text=True,
                          timeout=120, check=True).stdout


def ptxas_frames(log: str):
    """{kernel: "N bytes stack frame, ...; Used N registers ..."} from nvcc's
    -Xptxas -v output."""
    frames, kernel = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel = m.group(1)
            name = re.search(r"(hybrid_kernel|table_kernel|heston_qe_kernel|heston_ladder_kernel|"
                             r"recon_kernel|qe_tangents_kernel)(I\w*?EEv)?", kernel)
            if name:  # hybrid_kernelILi4ELb1EEv... -> hybrid_kernel<4,1>
                args = re.findall(r"L[ib](\d+)E", name.group(2) or "")
                kernel = name.group(1) + (f"<{','.join(args)}>" if args else "")
            continue
        if kernel and "stack frame" in line:
            frames[kernel] = line.strip()
        elif kernel and "registers" in line:
            frames[kernel] = f"{frames.get(kernel, '')}; {line.split(':', 1)[-1].strip()}"
    return frames


def sass_functions(text: str):
    """{kernel name: [(address, instruction, branch target or None)]} from
    cuobjdump -sass output."""
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and cur is not None:
            t = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", m.group(2))
            cur.append((int(m.group(1), 16), m.group(2), int(t.group(1), 16) if t else None))
    return funcs


def _draws(ops) -> bool:
    """Whether the instructions ``ops`` hold a Philox call."""
    return sum(bool(_PHILOX_MULTIPLY.search(o)) for o in ops) >= 10


def substep_loop(ins, nested_loops: bool = True):
    """The substep loop of a path kernel's SASS: (its instructions, the
    addresses of its slow paths).  The loop is the innermost one that holds
    a Philox call (ten rounds of two 32-bit multiplies), or the innermost
    loop where no draw is read (a deterministic CIR++ block alone, the
    ladder's no-draws rung); a slow path is a region a forward branch inside
    it skips that holds local-memory or CALL instructions or, with
    ``nested_loops``, a loop of its own: the special cases of IEEE division
    and square root, and the large-argument sincos reduction (|x| >= 105615;
    the angles here lie in [0, 2 pi)), whose six-word loop ptxas keeps
    either in local memory or in registers.  ``nested_loops=False`` is the
    older count, which took the reduction kept in registers for part of the
    substep (K1: 414 instructions against 304).  A region that holds a
    Philox call is a substep, never a slow path: it raises ValueError."""
    loops = [(t, a) for a, op, t in ins if t is not None and t < a]
    philox = [(t, a) for t, a in loops if _draws(o for x, o, _ in ins if t <= x <= a)]
    loops = philox or loops
    lo, hi = min(loops, key=lambda r: r[1] - r[0])
    body = [i for i in ins if lo <= i[0] <= hi]
    slow = set()
    for a, op, t in body:
        if t is not None and t > a and op.startswith("@"):
            region = [(x, o, u) for x, o, u in body if a < x < t]
            if any(re.search(r"\b(STL|LDL|CALL)", o)
                   or (nested_loops and u is not None and u < x) for x, o, u in region):
                if _draws(o for _, o, _ in region):
                    raise ValueError(f"the branch at {a:#x} skips a Philox call: a region of "
                                     f"substeps, not a slow path")
                slow.update(x for x, _, _ in region)
    return body, slow


class IssueSlots:
    """Issued instructions per path-substep of a path kernel, counted from
    its SASS (the instructions of the substep loop less its slow paths,
    which these launches never enter), and the least time the SMs' issue
    slots need for them: instructions x path-substeps / (132 SMs x 4
    schedulers x 32 lanes x the SM clock)."""

    def __init__(self, clock_mhz: float):
        self.clock_hz = clock_mhz * 1e6
        self._sass = {}

    @classmethod
    def from_card(cls):
        """At the card's maximum SM clock, as nvidia-smi reads it."""
        return cls(float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60, check=True).stdout.split()[0]))

    def functions(self, built):
        if built.path not in self._sass:
            self._sass[built.path] = sass_functions(sass_of(built))
        return self._sass[built.path]

    def per_substep(self, built, kernel: str, substeps_per_iteration: int = 1,
                    nested_loops: bool = True):
        """Instructions per path-substep of the first kernel whose name holds
        ``kernel`` (None without cuobjdump): its substep loop's outside the
        slow paths (:func:`substep_loop`, ``nested_loops`` passed on),
        divided by the substeps one iteration of that loop runs (4 in the
        ladder's batched rungs, whose loop takes a group of 4 substeps)."""
        funcs = self.functions(built)
        name = next((n for n in funcs if kernel in n), None)
        if name is None:
            return None
        body, slow = substep_loop(funcs[name], nested_loops)
        return (len(body) - len(slow)) / substeps_per_iteration

    def ms(self, instructions: float, path_substeps: float) -> float:
        """The issue-slot time of ``instructions`` per path-substep."""
        return instructions * path_substeps / (ISSUE_LANES_PER_CYCLE * self.clock_hz) * 1e3

    def slot_ms(self, label, built, kernel, path_substeps):
        n = self.per_substep(built, kernel)
        if n is None:
            print(f"[sass] {label}: not measured (no cuobjdump)")
            return None
        ms = self.ms(n, path_substeps)
        print(f"[sass] {label}: {n:g} instructions per path-substep -> issue-slot time {ms:.4f} ms "
              f"over {path_substeps:.3e} path-substeps at {self.clock_hz / 1e6:.0f} MHz")
        return ms
