"""K3's backward on rows with one live key: how far the kernel and the
plain version stray from each other, against a constant floor and against
``flash_backward_floor``.

At (B 2, S 1, G 1, hd = hd_v = 256), non-causal with k_len 1, over the 256
draws a type of ``tests/test_torch_flash.py::
test_cuda_backward_one_live_key_hd256`` (seed 11), p = 1 and O = v, so
ds = p (dO v - rowsum(dO O)) scale is the rounding noise of two 256-term
f32 sums and dq, dk are that noise times k, q.  For f32 and bf16 the
script prints, as one JSON line: how many of the 768 gradient checks fail
under the constant floor 1e-6 x max|dO| max|v| max|k or q| / sqrt(hd)
(``old_*``); the largest |dq - plain|; the largest ratio of |got - plain|
to the tolerance under each floor; the RMS of ds of the kernel and of the
plain version, read off dq / k at each row's largest |k|; and the largest
|ds| of each over one sum's sqrt(hd) u sum |dO_d v_d| scale (u = 2^-24).

    python3 scripts/k3_one_live_key.py [--src DIR]

on the card; ``--src`` takes another checkout's ``src`` (the derived floor
is computed here for S 1, so a checkout without ``flash_backward_floor``
can be read too).  The card's name and power limit come first.

    python3 scripts/k3_one_live_key.py --floors

needs no card: at each head width of ``K3.HEAD_DIMS``, over 32 draws of
unit-normal f32 q, k, v and dO at the same shape, ``flash_backward_floor``'s
dq floor against the constant one, as the median ratio at the largest
entry and the share of entries where it is the smaller.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

U = 2.0 ** -24
DRAWS, SEED, HD = 256, 11, 256


def _ulp(got, want):
    import numpy as np
    big = np.maximum(np.maximum(abs(got), abs(want)),
                     np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(big)) - 7)


def _ratio(got, want, floor, bf16):
    """max |got - want| over the tolerance with this floor."""
    import numpy as np
    tol = np.maximum(1e-4 * np.abs(want).max(), floor) + 1e-4 * np.abs(want)
    if bf16:
        tol = tol + _ulp(got, want)
    return float((np.abs(got - want) / tol).max())


def floors(K3) -> dict:
    """The derived dq floor against the constant one at each head width."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED)
    kw = dict(causal=False, k_len=1)
    out = {}
    for hd in K3.HEAD_DIMS:
        ratio, smaller = [], []
        for _ in range(32):
            q, k, v = (torch.as_tensor(rng.normal(size=(2, 1, 4, hd)),
                                       dtype=torch.float32)
                       for _ in range(3))
            o, lse = K3.flash_attention_plain(q, k, v, return_lse=True, **kw)
            do = torch.as_tensor(rng.normal(size=o.shape),
                                 dtype=torch.float32)
            fq = K3.flash_backward_floor(q, k, v, o, lse, do, **kw)[0]
            top = [float(t.abs().max()) for t in (q, k, v, do)]
            const = 1e-6 * top[3] * top[2] * top[1] / math.sqrt(hd)
            ratio.append(float(fq.max()) / const)
            smaller.append(float((fq < const).float().mean()))
        out[hd] = {"median_ratio_at_largest": float(np.median(ratio)),
                   "share_smaller": float(np.mean(smaller))}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--floors", action="store_true",
                    help="compare the floors on the CPU and exit")
    args = ap.parse_args(argv)
    sys.path.insert(0, args.src)
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attn import kernel as K3
    if args.floors:
        print(json.dumps(floors(K3)))
        return 0
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    kw = dict(causal=False, window=None, k_len=1)
    scale = 1.0 / math.sqrt(HD)
    out = {"K3": K3.__file__}
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        rng = np.random.default_rng(SEED)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        old_fails, old_worst, new_worst, dq_worst = 0, 0.0, 0.0, 0.0
        ds_k, ds_p, sums = [], [], []
        for _ in range(DRAWS):
            q, k, v = (torch.as_tensor(rng.normal(size=(2, 1, 4, HD))
                                       .astype(np.float32), device="cuda")
                       .to(dtype) for _ in range(3))
            o, lse = K3.flash_fill(q, k, v, p_dtype=dtype, return_lse=True,
                                   **kw)
            do = torch.randn(o.shape, generator=gen, device="cuda",
                             dtype=dtype)
            got = K3.flash_backward(q, k, v, o, lse, do, **kw)
            want = K3.flash_backward_plain(q, k, v, o, lse, do, **kw)
            torch.cuda.synchronize()
            top = [float(t.float().abs().max()) for t in (q, k, v, do)]
            const = (1e-6 * top[3] * top[2] * top[1] * scale,
                     1e-6 * top[3] * top[2] * top[0] * scale,
                     1e-6 * top[3])
            # the derived floor at S 1: p = 1, one key
            w = ((do.double().abs() * v.double().abs()).sum(-1)
                 + (do.double().abs() * o.double().abs()).sum(-1)) * scale
            c = 2 * U * math.sqrt(HD)
            derived = (c * w[..., None] * k.double().abs(),
                       c * w[..., None] * q.double().abs(),
                       2 * U * do.double().abs())
            for i, (g, ww) in enumerate(zip(got, want)):
                g, ww = g.float().cpu().numpy(), ww.float().cpu().numpy()
                r_old = _ratio(g, ww, const[i], bf16)
                old_fails += r_old > 1
                old_worst = max(old_worst, r_old)
                new_worst = max(new_worst, _ratio(
                    g, ww, derived[i].cpu().numpy(), bf16))
                if i == 0:
                    dq_worst = max(dq_worst, float(np.abs(g - ww).max()))
            kk = k.double().cpu()
            idx = kk.abs().argmax(-1, keepdim=True)
            kmax = kk.gather(-1, idx)
            ds_k.append((got[0].double().cpu().gather(-1, idx)
                         / kmax).flatten())
            ds_p.append((want[0].double().cpu().gather(-1, idx)
                         / kmax).flatten())
            sums.append((do.double() * v.double()).abs().sum(-1)
                        .cpu().flatten())
        ds_k, ds_p, sums = (torch.cat(x).numpy() for x in (ds_k, ds_p, sums))
        one_sum = math.sqrt(HD) * U * sums * scale
        out[str(dtype).replace("torch.", "")] = {
            "checks": 3 * DRAWS, "old_fails": int(old_fails),
            "old_worst_ratio": old_worst, "derived_worst_ratio": new_worst,
            "max_dq_diff": dq_worst,
            "ds_rms_kernel": float(np.sqrt((ds_k ** 2).mean())),
            "ds_rms_plain": float(np.sqrt((ds_p ** 2).mean())),
            "ds_max_over_one_sum_kernel": float((np.abs(ds_k)
                                                 / one_sum).max()),
            "ds_max_over_one_sum_plain": float((np.abs(ds_p)
                                                / one_sum).max()),
            "mean_sum_abs_dO_v": float(sums.mean())}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
