"""Observability utils."""

import json

import jax.numpy as jnp

from mhc.utils import metrics


def test_trace_phases():
    tr = metrics.Trace()
    x = jnp.ones((128, 128))
    with tr.phase("matmul", nbytes=128 * 128 * 4, sync=x):
        y = x @ x
    with tr.phase("matmul", nbytes=128 * 128 * 4, sync=y):
        y = y @ x
    rep = tr.report()
    assert rep["matmul"]["calls"] == 2
    assert rep["matmul"]["bytes"] == 2 * 128 * 128 * 4
    assert rep["matmul"]["seconds"] > 0
    json.loads(tr.dumps())


def test_scaling_report():
    rep = metrics.scaling_report(per_device_bytes=1 << 20, n_devices=8,
                                 seconds_1=8.0, seconds_n=1.25)
    assert rep["scaling_efficiency"] == 0.8
    assert rep["n_devices"] == 8
