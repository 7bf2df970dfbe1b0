"""Multi-host glue: a REAL 2-process localhost ``jax.distributed`` run
through ``initialize_distributed`` + ``make_map_mesh`` +
``make_hybrid_mesh`` (VERDICT r3 #7 — no untested public API in
parallel/mesh.py).

Each worker process forces the CPU backend with 2 virtual devices, joins
the coordination service, builds the 1-D map mesh (4 global devices) and
the 2-D (process, local-device) hybrid mesh (2x2), and runs a psum over each; the
parent asserts both workers exit 0 with matching results.

The reference is single-process (SURVEY §5.8) — this is the scale-out
surface the reference does not have.
"""

import os
import socket
import subprocess
import sys

import pytest

WORKER = r"""
import os, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
from jax.sharding import NamedSharding, PartitionSpec as P

from ptam_cg_tpu.parallel import mesh as meshlib

# Args-free path: everything comes from the JAX_* env vars.
assert meshlib.initialize_distributed() is True
pid = jax.process_index()
assert jax.process_count() == 2
assert len(jax.devices()) == 4, jax.devices()
assert len(jax.local_devices()) == 2

# 1-D map mesh over all 4 global devices.
m1 = meshlib.make_map_mesh()
assert m1.devices.shape == (4,) and m1.axis_names == ("mp",)

# 2-D (host, chip) hybrid mesh: 2 processes x 2 local devices.
m2 = meshlib.make_hybrid_mesh()
assert m2.devices.shape == (2, 2) and m2.axis_names == ("host", "chip")
# Row p of the grid must hold process p's local devices (the psum along
# "chip" rides intra-host links; "host" crosses processes).
for p in range(2):
    assert all(d.process_index == p for d in m2.devices[p]), m2.devices

def global_iota(mesh, spec, shape):
    sharding = NamedSharding(mesh, spec)
    full = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    return jax.make_array_from_callback(
        shape, sharding, lambda idx: full[idx])

# shard_map psum over the 1-D mesh. The P() output is replicated, so
# every process can read its local copy directly.
from jax import shard_map
x1 = global_iota(m1, P("mp"), (8,))
f1 = jax.jit(shard_map(lambda x: jax.lax.psum(x.sum(), "mp"),
                       mesh=m1, in_specs=P("mp"), out_specs=P()))
s1 = float(np.asarray(f1(x1).addressable_data(0)))
assert s1 == float(np.arange(8).sum()), s1

# shard_map psum over BOTH hybrid axes.
x2 = global_iota(m2, P("host", "chip"), (4, 4))
f2 = jax.jit(shard_map(
    lambda x: jax.lax.psum(jax.lax.psum(x.sum(), "chip"), "host"),
    mesh=m2, in_specs=P("host", "chip"), out_specs=P()))
s2 = float(np.asarray(f2(x2).addressable_data(0)))
assert s2 == float(np.arange(16).sum()), s2

print(f"WORKER_OK {pid} {s1} {s2}")
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_distributed_meshes(tmp_path):
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update({
            "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
            "JAX_NUM_PROCESSES": "2",
            "JAX_PROCESS_ID": str(pid),
            "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
            # Worker processes must not inherit the test process's own
            # distributed/client state.
            "PYTHONPATH": os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))),
        })
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, (rc, out, err[-2000:])
        assert "WORKER_OK" in out, (out, err[-2000:])
    # Both processes computed the same global sums.
    lines = sorted(o.strip().splitlines()[-1] for _, o, _ in outs)
    assert lines[0].split()[2:] == lines[1].split()[2:], lines
