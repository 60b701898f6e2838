"""How a bf16 matrix product rounds on one NVIDIA GPU: for each shape
(M, K, N) of the sharded training program's products, the share of
elements where `torch.mm` of bf16 operands differs from

  * `torch.mm(..., out_dtype=torch.float32)` rounded to bf16 (the tensor
    cores' f32 accumulator, which the bf16 product rounds once);
  * the f32 product of the same values rounded to bf16;
  * two f32 half-K products summed, rounded to bf16 (a row-parallel
    product over two ranks, summed in f32).

    python3 scripts/bf16_product_rounding.py

Seeded normal operands, deterministic cuBLAS, TF32 off. Prints the card's
name and power limit. Imports nothing of JAX.
"""
import subprocess
import sys

import torch

SHAPES = ((1024, 4096, 4096), (1024, 4096, 2048), (1024, 2048, 4096),
          (1024, 896, 896), (1024, 4864, 896), (4096, 1024, 16032),
          (1024, 32064, 4096))


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    for M, K, N in SHAPES:
        a = torch.randn(M, K, generator=gen, device="cuda").bfloat16()
        b = torch.randn(K, N, generator=gen, device="cuda").bfloat16()
        ref = torch.mm(a, b)
        acc = torch.mm(a, b, out_dtype=torch.float32)
        f32 = torch.mm(a.float(), b.float())
        h = K // 2
        halves = (torch.mm(a[:, :h].float(), b[:h].float())
                  + torch.mm(a[:, h:].float(), b[h:].float()))

        def share(x):
            return float((x.bfloat16() != ref).float().mean())
        print(f"M {M} K {K} N {N}: differs from the bf16 product in "
              f"{share(acc):.3e} (f32 accumulator), {share(f32):.3e} (f32 "
              f"product), {share(halves):.3e} (two f32 halves) of elements",
              flush=True)


if __name__ == "__main__":
    main()
