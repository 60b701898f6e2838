"""One training step of qwen2-0.5b at full width and depth at B = 1,
S = 4096 under `none` and under `sequential`, then one xla prefill at that
length, on one NVIDIA GPU (`chip_smoke.py::chunked_train_steps`), with the
port's package taken from SRC:

    python3 scripts/s4096_step.py [SRC]

SRC defaults to this checkout's `src`. Given another tree's `src` (e.g. an
earlier commit unpacked with `git archive` into a git-ignored directory),
it measures that tree's code on the same card: a step or a prefill that
runs out of the card's memory is reported with its peak, not raised.
Prints peak memory, ms and K1's launches per step, and the card's name and
power limit. Imports nothing of JAX.
"""
import os
import subprocess
import sys

if __name__ == "__main__":
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    src = os.path.abspath(sys.argv[1] if len(sys.argv) > 1
                          else os.path.join(here, "src"))
    sys.path.insert(0, src)
    sys.path.insert(1, here)
    import chip_smoke as cs       # sets the cuBLAS and allocator env first
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    import repro_torch
    from repro_torch.device import make_deterministic
    from repro_torch.kernels import _build, fingerprint as kfp
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    print(f"package: {os.path.dirname(repro_torch.__file__)}", flush=True)
    make_deterministic(torch.device("cuda"))
    _build.build(["fingerprint"])
    cs.chunked_train_steps(kfp, allow_oom=True)
