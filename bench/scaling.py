"""Scaling-efficiency measurement (BASELINE.json:5: ">=80% linear
scaling ... measured at 1 chip, 1 host, and N hosts").

    python bench/scaling.py [MB_per_device] [--update-results]

Only one real chip exists in this environment, so scaling is measured
on 1/2/4/8-device CPU meshes (one subprocess per device count — JAX
fixes the device count at backend init), WEAK-scaling style: every
device count gets the same bytes PER DEVICE (total = d * B0).

Method note (round 3 — replaces the caveat-only strong-scaling table):
CPU mesh devices share physical cores, so the d shards' compute
serializes: the ideal no-overhead wall on shared cores is d * T1 where
T1 is the 1-device sharded-pipeline wall on B0. Everything above that,
T(d) - d*T1, is mesh/collective/host orchestration overhead — the part
that would NOT parallelize on real chips. The projected d-chip
efficiency assumes the compute runs concurrently on real hardware but
the overhead stays serial:

    projected_wall(d)  = T(d) - (d-1)*T1
    efficiency(d)      = T1 / projected_wall(d)

Assumptions: (1) per-shard compute on a real chip is shard-size
invariant (same kernel, same shapes — holds by construction), (2) the
measured overhead does not shrink on real chips (conservative: ICI
collectives are faster than this host's loopback), (3) host-side
container assembly stays on one process as in the real multi-host path.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

_CHILD = r"""
import json, sys, time
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", int(sys.argv[1]))
sys.path.insert(0, "__REPO__")
import bench as bench_mod
from mhc.parallel import mesh as meshmod, pipeline

nd = int(sys.argv[1])
n = (int(sys.argv[2]) << 20) * nd            # weak scaling: B0 per device
data = bench_mod.make_corpus(n)
m = meshmod.make_mesh(nd)
blob = pipeline.compress_sharded(data, m)          # warm-up compile
assert pipeline.decompress_sharded(blob, m) == data
best_e = best_d = 1e9
for _ in range(2):
    t0 = time.perf_counter()
    blob = pipeline.compress_sharded(data, m)
    best_e = min(best_e, time.perf_counter() - t0)
    t0 = time.perf_counter()
    out = pipeline.decompress_sharded(blob, m)
    best_d = min(best_d, time.perf_counter() - t0)
assert out == data
print(json.dumps({"n_devices": nd, "encode_s": best_e,
                  "decode_s": best_d}))
"""


def main() -> int:
    n_mb = int(sys.argv[1]) if len(sys.argv) > 1 and sys.argv[1].isdigit() \
        else 8
    rows = []
    for nd in (1, 2, 4, 8):
        r = subprocess.run(
            [sys.executable, "-c", _CHILD.replace("__REPO__", REPO),
             str(nd), str(n_mb)],
            capture_output=True, text=True, timeout=2400)
        if r.returncode != 0:
            print(f"n_devices={nd} FAILED: {r.stderr[-300:]}",
                  file=sys.stderr)
            continue
        row = json.loads(r.stdout.strip().splitlines()[-1])
        row["agg_s"] = row["encode_s"] + row["decode_s"]
        rows.append(row)
        print(json.dumps(row), flush=True)
    if not rows or rows[0]["n_devices"] != 1:
        return 1
    t1 = rows[0]["agg_s"]
    for r in rows:
        d = r["n_devices"]
        overhead = max(r["agg_s"] - d * t1, 0.0)
        proj_wall = t1 + overhead / 1  # overhead assumed serial
        r["overhead_s"] = round(overhead, 3)
        r["projected_wall_s"] = round(proj_wall, 3)
        r["projected_efficiency"] = round(t1 / proj_wall, 3)
    print(json.dumps({"mb_per_device": n_mb, "rows": rows}))
    if "--update-results" in sys.argv:
        lines = [
            "",
            f"## Weak-scaling proxy (CPU mesh, {n_mb} MB/device markov, "
            "encode+decode wall)",
            "",
            "Fixed bytes per device; shared-core ideal wall = d x t(1). "
            "`overhead` = t(d) - d x t(1) is the mesh/collective/host "
            "orchestration cost that would stay serial on real chips; "
            "`proj eff` = t(1) / (t(1) + overhead) is the projected "
            "d-chip efficiency under the assumptions in "
            "bench/scaling.py's docstring.",
            "",
            "| devices | total MB | agg s | overhead s | proj eff |",
            "|---|---|---|---|---|",
        ]
        for r in rows:
            lines.append(
                f"| {r['n_devices']} | {n_mb * r['n_devices']} | "
                f"{r['agg_s']:.2f} | {r['overhead_s']:.2f} | "
                f"{r['projected_efficiency']:.2f} |")
        with open(os.path.join(REPO, "RESULTS.md"), "a") as f:
            f.write("\n".join(lines) + "\n")
        print("appended to RESULTS.md")
    return 0


if __name__ == "__main__":
    sys.exit(main())
