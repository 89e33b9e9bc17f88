"""Registers, spills and shared memory of the kernels that two checkouts
share, so that a change can show that it left the earlier kernels' code as
it was.

    python tests/kernel_resources_ab.py <checkout a> <checkout b>

Builds each checkout's kernels with its own package (``build_library``, in
a subprocess; a build that exists is reused) and compares their
``-Xptxas -v`` reports.  Prints each side's build time (``BUILD``: cold where
the checkout had no build of its sources yet, the usual case on a fresh
machine), the kernels only one side has, one line per shared kernel whose
resources differ, and a last line ``REGS shared=N differing=M``.  Needs nvcc.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

BUILD = ("import json; from tnl_lbm_tpu_torch.kernels.build import build_library, "
         "kernel_resources; print(json.dumps(kernel_resources(build_library()[1])))")


def resources(root: Path) -> dict:
    built = list((root / "build" / "torch_kernels").glob("*.so"))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", BUILD], cwd=root, capture_output=True,
                         text=True, check=True, env={**os.environ, "PYTHONPATH": str(root)})
    print(f"BUILD {root} seconds={time.perf_counter() - t0:.1f} "
          f"{'(a library was there before)' if built else 'cold'}", flush=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    a, b = (resources(Path(p).resolve()) for p in sys.argv[1:3])
    shared = sorted(set(a) & set(b))
    differing = [k for k in shared if a[k] != b[k]]
    print(f"REGS only_a={sorted(set(a) - set(b))} only_b={sorted(set(b) - set(a))}")
    for k in differing:
        print(f"REGS DIFF {k} {a[k]} {b[k]}")
    print(f"REGS shared={len(shared)} differing={len(differing)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
