"""Quickstart: the paper's sparse ternary GEMM, end to end, on the port.

1. quantize a dense weight matrix to ternary (TWN absmean),
2. build the paper's TCSC / BlockedTCSC / InterleavedTCSC formats,
3. pack into a typed ``weights.TernaryWeight`` container (2-bit kernel
   format, scale/bias metadata riding along),
4. inspect the registry's ``GemmPlan``, run the hand-written kernel (B1,
   ``csrc/ternary_gemm.cu``, on the card) and every reference algorithm,
   checking they all agree.

On the card B1 takes bfloat16 activations and returns bfloat16, so there
the activations are rounded to bfloat16 once and every variant is held
against the float32 dense product of those same values: the reference
algorithms (float32 throughout) within 1e-3, B1 within 1e-3 plus the half
bfloat16 ulp its one rounding of the output may cost. On the CPU
everything runs in float32 and every variant is held within 1e-3.

Run:  PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
"""
import argparse
import json

import numpy as np
import torch

from repro_torch.core import formats, quantize, weights
from repro_torch.device import resolve_device
from repro_torch.kernels import ops, ref

TOL = 1e-3
# half an ulp of a bfloat16 value v is at most |v| * 2^-8 (8 significant
# bits): what B1's one rounding of its float32 result may cost
BF16_HALF_ULP = 2.0 ** -8


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    act = torch.bfloat16 if dev.type == "cuda" else torch.float32

    rng = np.random.default_rng(0)
    m, k, n = 32, 2048, 1024

    # --- 1. quantize dense weights to ternary (the paper's input) --------
    w_dense = torch.as_tensor(rng.standard_normal((k, n)) * 0.05,
                              dtype=torch.float32, device=dev)
    t, alpha = quantize.ternarize(w_dense)          # T in {-1,0,1}, scales
    t_np = t.cpu().numpy()
    sparsity = (t_np != 0).mean()
    print(f"ternarized: {sparsity:.1%} nonzero (paper's 's')")

    # --- 2. the paper's sparse formats ------------------------------------
    tcsc = formats.TCSC.from_dense(t)
    blocked = formats.BlockedTCSC.from_dense(t, block_size=4096)
    inter = formats.InterleavedTCSC.from_dense(t, group=4)
    print(f"TCSC bytes: {tcsc.nbytes():,} "
          f"(dense f32 would be {t_np.size * 4:,})")

    # --- 3. typed kernel containers: 2 bits/weight, 16 per u32 word ------
    bias = torch.as_tensor(rng.standard_normal(n) * 0.1,
                           dtype=torch.float32, device=dev)
    alpha_v = alpha.reshape(-1)
    wc = weights.pack(t, "dense2bit", scale=alpha_v, bias=bias)
    print(f"{type(wc).__name__} payload bytes: {wc.nbytes:,} "
          f"({t_np.size * 4 / wc.nbytes:.0f}x smaller than f32; "
          f"occupancy {wc.occupancy():.1%})")

    # --- 4. plan, run everything and compare ------------------------------
    x32 = torch.as_tensor(rng.standard_normal((m, k)), dtype=torch.float32,
                          device=dev)
    x = x32.to(act)                 # the kernel's activations
    xf = x.float()                  # the same values in float32
    plan = ops.ternary_gemm_plan(wc, m)
    print(f"GemmPlan: {plan.format}/{plan.impl} blocks="
          f"{plan.block_m}x{plan.block_n}x{plan.block_k}")

    y_oracle = ref.ternary_matmul_dense(xf, t, alpha_v, bias)
    y_kernel = ops.ternary_gemm(x, wc)     # scale/bias ride in the container
    y_tcsc = ref.tcsc_matmul(xf, tcsc, alpha_v, bias)
    y_blocked = ref.tcsc_matmul_blocked(xf, blocked, alpha_v, bias)
    y_inter = ref.tcsc_matmul_interleaved(xf, inter, alpha_v, bias)
    y_base3 = ops.ternary_gemm(
        xf, weights.pack(t, "base3", scale=alpha_v, bias=bias))

    kernel_tol = TOL + (BF16_HALF_ULP * float(y_oracle.abs().max())
                        if act == torch.bfloat16 else 0.0)
    errors, outputs = {}, {}
    for name, y, tol in [
            (f"{plan.format}/{plan.impl}", y_kernel, kernel_tol),
            ("TCSC", y_tcsc, TOL), ("BlockedTCSC", y_blocked, TOL),
            ("InterleavedTCSC", y_inter, TOL), ("Base3 (ref)", y_base3, TOL)]:
        err = float((y.float() - y_oracle).abs().max())
        errors[name] = err
        outputs[name] = y.float().cpu().numpy()
        print(f"{name:18s} max|err| = {err:.2e} (bound {tol:.2e})")
        assert err < tol, f"{name}: max|err| {err} >= {tol}"

    print("all variants agree — the paper's algorithm family is consistent")
    summary = {"device": str(dev), "activations": str(act).split(".")[-1],
               "shape": [m, k, n], "nonzero": float(sparsity),
               "tcsc_bytes": tcsc.nbytes(), "blocked_bytes": blocked.nbytes(),
               "interleaved_bytes": inter.nbytes(),
               "dense2bit_bytes": wc.nbytes, "occupancy": wc.occupancy(),
               "plan": {"format": plan.format, "impl": plan.impl,
                        "blocks": [plan.block_m, plan.block_n,
                                   plan.block_k]},
               "max_abs_err": errors, "kernel_bound": kernel_tol}
    print(json.dumps(summary))
    # returned beside the printed summary: each variant's output, and the
    # oracle's, as float32 numpy arrays
    outputs["oracle"] = y_oracle.cpu().numpy()
    return dict(summary, outputs=outputs)


if __name__ == "__main__":
    main()
