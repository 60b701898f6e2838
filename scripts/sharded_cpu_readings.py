"""The readings that `tests/test_torch_sharded_program.py`'s bounds rest
on, from its own harness on the CPU (4 gloo ranks against the
reference's program in a subprocess with forced host devices):

    PYTHONPATH=src python3 scripts/sharded_cpu_readings.py

  * f32 compute (cases sp_on, sp_off_micro2 and the tp file's moe): for
    each leaf of m after step 0, the element term that `grads_bound`
    needs beyond MAX_TOL of the leaf's max, in units of BF16_RTOL of the
    element, and the leaf-max term it would need instead (of the leaf's
    max);
  * bf16 compute (bf16_sp_on, bf16_sedar): each case's worst leaf against
    the reference, and the port's and the reference's sharded programs'
    worst leaves against their own run on one rank (one device).

Imports nothing of JAX; the harness runs the reference in a subprocess.
"""
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "tests"))
sys.path.insert(0, os.path.join(HERE, "src"))


def main() -> None:
    import test_torch_sharded_program as H
    import test_torch_tp as T
    from repro_torch import tree as tu

    f32 = [c for c in H.CASES if c["name"] in ("sp_on", "sp_off_micro2")]
    f32 += [c for c in T.CASES if c["name"] == "moe"]
    bf16 = [c for c in H.CASES if c["name"].startswith("bf16_")]
    cases = f32 + bf16 + [H.BF16_ONE]
    port, ref = H.run_both(cases)

    def m_of(c):
        return dict(tu.flatten_with_path(H.gathered(c, port[c["name"]], "m")))
    for c in f32:
        for path, got in m_of(c).items():
            want = ref[c["name"]]["trees"]["m" + path]
            a = np.abs(want)
            over = np.abs(got.numpy() - want) - H.MAX_TOL * a.max()
            elem = float(np.max(over / np.maximum(a, 1e-30))) / H.BF16_RTOL
            print(f"{c['name']} {path}: element term {elem:.2f} x BF16_RTOL"
                  f", or {float(over.max()) / a.max():.3e} of the leaf's "
                  "max", flush=True)
    one = m_of(H.BF16_ONE)
    ref_one = ref["bf16_one"]["trees"]

    def worst(x, y):
        return max((float(np.abs(np.asarray(x[k]) - np.asarray(y[k])).max()
                          / np.abs(np.asarray(y[k])).max()), k) for k in y)
    for c in bf16:
        got = {p: t.numpy() for p, t in m_of(c).items()}
        want = {p: ref[c["name"]]["trees"]["m" + p] for p in got}
        sharded = {k: v for k, v in ref[c["name"]]["trees"].items()
                   if k.startswith("m")}
        single = {k: v for k, v in ref_one.items() if k.startswith("m")}
        print(f"{c['name']}: against the reference {worst(got, want)}; the "
              f"port's sharded vs one rank "
              f"{worst(got, {p: t.numpy() for p, t in one.items()})}; the "
              f"reference's sharded vs one device {worst(sharded, single)}",
              flush=True)


if __name__ == "__main__":
    main()
