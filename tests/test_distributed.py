"""Multi-host runtime glue test (SURVEY §2.12 / PARITY "multi-host runtime").

Launches TWO real OS processes, each a separate "host" with 4 virtual CPU
devices, wires them through ``parallel/distributed.initialize`` (coordinator
on localhost) and proves the global runtime works end to end: 8 global
devices vs 4 local, primary-rank detection, and a cross-process psum over
the global ('sp','dp') mesh — the same collective the renderer's
sample-parallel axis rides (parallel/sharding.py).

The reference is single-process (SURVEY §2.12); this validates the glue the
framework adds for multi-host scale without needing several hosts.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import pytest

_WORKER = textwrap.dedent("""
    import json, sys

    # Pin the workers to the CPU through the config API as well as the
    # env var, exactly as tests/conftest.py does for the in-process suite
    # (importing jax does not initialize a backend).
    import jax
    jax.config.update("jax_platforms", "cpu")

    # initialize() must run before anything touches the XLA backend —
    # the module deliberately imports nothing that does.
    from raytrace2.parallel import distributed

    distributed.initialize()  # env-var config, the multi-host launcher path

    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from jax.experimental.shard_map import shard_map

    from raytrace2.parallel import sharding

    mesh = sharding.make_mesh(sp=2)  # 2x2 over the 4 GLOBAL devices

    @jax.jit
    def global_sum():
        def body():
            local = jnp.ones(())
            return jax.lax.psum(jax.lax.psum(local, "sp"), "dp")
        return shard_map(body, mesh=mesh, in_specs=(), out_specs=P())()

    out = {
        "pid": jax.process_index(),
        "primary": distributed.is_primary(),
        "local_devices": jax.local_device_count(),
        "global_devices": distributed.global_device_count(),
        "psum": float(global_sum()),
    }
    print("RESULT " + json.dumps(out))
""")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(port):
    procs = []
    for rank in range(2):
        env = dict(
            os.environ,
            JAX_PLATFORMS="cpu",
            XLA_FLAGS="--xla_force_host_platform_device_count=2",
            JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
            JAX_NUM_PROCESSES="2",
            JAX_PROCESS_ID=str(rank),
        )
        env.pop("JAX_PLATFORM_NAME", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env,
        ))
    return procs


def test_two_process_runtime(tmp_path):
    # One retry with a fresh coordinator port: the rendezvous can time out
    # OR fail outright (nonzero worker exit) when a loaded host starves
    # worker startup (measured 5 s idle; seen as a barrier timeout under a
    # full parallel suite run).
    for attempt in range(2):
        procs = _launch(_free_port())
        results = {}
        try:
            for rank, p in enumerate(procs):
                out, err = p.communicate(timeout=600)
                assert p.returncode == 0, f"rank {rank} failed:\n{err[-2000:]}"
                line = [ln for ln in out.splitlines()
                        if ln.startswith("RESULT ")]
                assert line, out
                results[rank] = json.loads(line[0][len("RESULT "):])
            break
        except (subprocess.TimeoutExpired, AssertionError):
            for p in procs:
                p.kill()
            if attempt == 1:
                raise

    for rank, r in results.items():
        assert r["pid"] == rank
        assert r["primary"] == (rank == 0)
        assert r["local_devices"] == 2
        assert r["global_devices"] == 4
        assert r["psum"] == 4.0  # the cross-process collective really ran
