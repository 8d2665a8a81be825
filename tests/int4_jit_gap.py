"""How far vitax's A4W4 attention half under `jax.jit` lies from the port's
composition of it (tests/test_torch_int4_attn_decomposition.py), beside
eager vitax: ‖Δ‖/‖ref‖ of the forward's out and of each backward grad, for
the file's GQA groupings, in interpret mode on the CPU. Under jit XLA
turns `amax / 7.0` in vitax's host weight quantizers into amax·(1/7); the
port divides, as eager vitax does.

    JAX_PLATFORMS=cpu python -m tests.int4_jit_gap
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from tests import test_torch_int4_attn_decomposition as t4
from vitax.ops import pallas_kernels as pk


def _rel(out, ref):
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    out = out.float().numpy().reshape(ref.shape)
    return float(np.linalg.norm(out - ref) / max(np.linalg.norm(ref), 1e-30))


def main():
    pk._INTERPRET = True
    for h, hkv, hd in t4.GQA:
        arrays = t4._arrays(52, h, hkv, hd)
        j = t4._jax(arrays)
        args = tuple(j[k] for k in t4.QKVO + ("bo",))
        fwd = functools.partial(pk.fused_ln_qkvo_attention, eps=t4.EPS,
                                seq_len=t4.SEQ, heads=h, head_dim=hd,
                                int8=True, int4=True, kv_heads=hkv)
        out, _ = t4.int4_fwd_composed(t4._torch(arrays), h, hkv, hd)
        print(f"heads {h} kv {hkv} hd {hd} forward out: eager "
              f"{_rel(out, fwd(*args)):.3e}, jit "
              f"{_rel(out, jax.jit(fwd)(*args)):.3e}", flush=True)
        for int8_dw in (False, True):
            arrays = t4._arrays(54, h, hkv, hd)
            j = t4._jax(arrays)
            bwd = functools.partial(pk._fused_ln_qkvo_bwd, t4.EPS, t4.SEQ, h,
                                    hd, True, True, int8_dw, True, True, hkv)
            ins = (tuple(j[k] for k in t4.QKVO), j["do"])
            eager, jitted = bwd(*ins), jax.jit(bwd)(*ins)
            outs, _ = t4.int4_bwd_composed(t4._torch(arrays), h, hkv, hd,
                                           int8_dw)
            print(f"  backward int8_dw={int8_dw} (eager, jit): " + ", ".join(
                f"{n} {_rel(o, e):.2e} {_rel(o, g):.2e}"
                for n, o, e, g in zip(t4.NAMES, outs, eager, jitted)),
                flush=True)


if __name__ == "__main__":
    main()
