"""Multi-host (DCN-analogue) trajectory striping, actually exercised.

VERDICT r2 #8 / SURVEY §2.3: two REAL processes form a jax.distributed
cluster (CPU backend, localhost coordinator), each reads its own frame
stripe of the shared fixture via `TrajReader.with_host_shard(i, 2)` (byte
ranges from the frame index — the cross-host generalization of the
reference's per-thread striding, parallel.rs:425-448), computes per-frame
COMs on its local device, and the stripes merge with a cross-process
allgather collective.  The interleaved result must equal the single-host
pass exactly.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import json, os, sys
import numpy as np
import jax

pid = int(sys.argv[1]); port = sys.argv[2]
jax.distributed.initialize(f"localhost:{port}", num_processes=2,
                           process_id=pid)
sys.path.insert(0, %(repo)r)
from groan_rs_tpu.system import System
from groan_rs_tpu.io.traj import traj_iter
from groan_rs_tpu.ops import center as center_ops
import jax.numpy as jnp

s = System.from_file(%(gro)r)
reader = traj_iter(s, %(xtc)r, batch_size=4).with_host_shard(pid, 2)
coms = []
for fb in reader.batches():
    g = jnp.asarray(fb.positions)
    box = jnp.asarray(fb.box_lengths())
    coms.append(np.asarray(center_ops.center(g, box[:, None, :])))
local = (np.concatenate(coms) if coms else np.zeros((0, 3), np.float32))

# cross-host merge: pad stripes to a common length, allgather over the
# 2-process cluster, reassemble the interleaving
from jax.experimental import multihost_utils

n_local = np.int32(local.shape[0])
counts = np.asarray(multihost_utils.process_allgather(n_local))
pad = int(counts.max())
padded = np.zeros((pad, 3), np.float32)
padded[: local.shape[0]] = local
gathered = np.asarray(multihost_utils.process_allgather(padded))  # [2, pad, 3]

total = int(counts.sum())
merged = np.zeros((total, 3), np.float32)
for h in range(2):
    merged[h::2] = gathered[h][: counts[h]]
if pid == 0:
    print("RESULT " + json.dumps({"n": total, "coms": merged.tolist()}))
jax.distributed.shutdown()
"""


def test_two_process_host_striping_equals_single_host(test_files, tmp_path):
    gro = os.path.join(test_files, "example.gro")
    xtc = os.path.join(test_files, "short_trajectory.xtc")

    results = _spawn_cluster(_WORKER, 2,
                             {"repo": REPO, "gro": gro, "xtc": xtc},
                             timeout=240, retries=1)
    for rc, out, err in results:
        assert rc == 0, f"worker failed:\n{out}\n{err}"
    outs = [out for _, out, _ in results]

    line = next(ln for ln in outs[0].splitlines() if ln.startswith("RESULT "))
    result = json.loads(line[len("RESULT "):])
    merged = np.asarray(result["coms"], np.float32)

    # single-host reference pass (same ops, same device count semantics)
    import jax.numpy as jnp

    from groan_rs_tpu.io.traj import traj_iter
    from groan_rs_tpu.ops import center as center_ops
    from groan_rs_tpu.system import System

    s = System.from_file(gro)
    reader = traj_iter(s, xtc, batch_size=4)
    coms = []
    for fb in reader.batches():
        g = jnp.asarray(fb.positions)
        box = jnp.asarray(fb.box_lengths())
        coms.append(np.asarray(center_ops.center(g, box[:, None, :])))
    single = np.concatenate(coms)

    assert result["n"] == single.shape[0]
    np.testing.assert_allclose(merged, single, rtol=0, atol=1e-6)


def _spawn_cluster(script_tpl, n, fmt, timeout=420, retries=0):
    """Launch an n-process jax.distributed CPU cluster running
    `script_tpl % fmt`; returns [(returncode, stdout, stderr)].

    `retries`: re-launch the whole cluster if any worker fails —
    for tests whose workers must all succeed; on a host with few cores
    a loaded suite can starve the coordinator handshake past its
    timeout (a real flake seen in full-suite runs, never in
    isolation)."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = str(sock.getsockname()[1])
    script = script_tpl % fmt
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = " ".join(
        f for f in env.get("XLA_FLAGS", "").split()
        if "host_platform_device_count" not in f
    )
    procs = [
        subprocess.Popen([sys.executable, "-c", script, str(i), port],
                         env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
        for i in range(n)
    ]
    results = []
    for p in procs:
        out, err = p.communicate(timeout=timeout)
        results.append((p.returncode, out, err))
    if retries and any(rc != 0 for rc, _, _ in results):
        return _spawn_cluster(script_tpl, n, fmt, timeout=timeout,
                              retries=retries - 1)
    return results


_FAIL_WORKER = r"""
import os, sys
import numpy as np
import jax

pid = int(sys.argv[1]); port = sys.argv[2]
jax.distributed.initialize(f"localhost:{port}", num_processes=2,
                           process_id=pid)
sys.path.insert(0, %(repo)r)
from groan_rs_tpu.errors import ParallelError
from groan_rs_tpu.parallel import striped_batches
from groan_rs_tpu.io.traj import traj_iter
from groan_rs_tpu.system import System

s = System.from_file(%(gro)r)
reader = traj_iter(s, %(xtc)r, batch_size=2).with_host_shard(pid, 2)
loader = reader.batches()

def stripe():
    done = 0
    for fb in loader:
        if pid == 1 and done == 1:
            raise RuntimeError("simulated decode failure on host 1")
        done += 1
        yield fb

try:
    n = 0
    for fb in striped_batches(stripe(), len(loader)):
        n += fb.positions.shape[0]
    print("UNEXPECTED-COMPLETION")
    sys.exit(3)
except ParallelError as e:
    # BOTH hosts must land here: the failing one chains the original
    # error, the peer gets the cross-host flag form
    print(f"GOT-PARALLEL-ERROR host={pid}: {e}")
    sys.exit(7)
"""


def test_two_process_failure_propagates(test_files):
    """A worker that raises mid-pass must surface a ParallelError on the
    PEER host too (not a hang): the reference's shared-error-flag
    contract (parallel.rs:298-309) over jax.distributed."""
    gro = os.path.join(test_files, "example.gro")
    xtc = os.path.join(test_files, "short_trajectory.xtc")
    results = _spawn_cluster(_FAIL_WORKER, 2,
                             {"repo": REPO, "gro": gro, "xtc": xtc})
    for rc, out, err in results:
        assert rc == 7, f"worker did not raise ParallelError:\n{out}\n{err}"
        assert "GOT-PARALLEL-ERROR" in out


_UNEVEN_WORKER = r"""
import json, os, sys
import numpy as np
import jax

pid = int(sys.argv[1]); port = sys.argv[2]
jax.distributed.initialize(f"localhost:{port}", num_processes=4,
                           process_id=pid)
sys.path.insert(0, %(repo)r)
from groan_rs_tpu.parallel import merge_striped, striped_batches
from groan_rs_tpu.io.traj import traj_iter
from groan_rs_tpu.ops import center as center_ops
from groan_rs_tpu.system import System
import jax.numpy as jnp

s = System.from_file(%(gro)r)
# stripe index deliberately PERMUTED vs the process index: merge_striped
# must reassemble by the declared host_id, not by allgather order
stripe = (pid + 1) %% 4
reader = traj_iter(s, %(xtc)r, batch_size=2).with_host_shard(stripe, 4)
loader = reader.batches()
coms = []
for fb in striped_batches(loader, len(loader)):
    g = jnp.asarray(fb.positions)
    box = jnp.asarray(fb.box_lengths())
    coms.append(np.asarray(center_ops.center(g, box[:, None, :])))
local = (np.concatenate(coms) if coms else np.zeros((0, 3), np.float32))
merged = merge_striped(local, 4, stripe)
if pid == 0:
    print("RESULT " + json.dumps({"n": merged.shape[0],
                                  "coms": merged.tolist()}))
jax.distributed.shutdown()
"""


def test_four_process_uneven_stripes_merge_exactly(test_files):
    """11 frames over 4 hosts = stripes of 3/3/3/2: the uneven case the
    round-3 suite never exercised.  The merged series must equal the
    single-host pass exactly."""
    gro = os.path.join(test_files, "example.gro")
    xtc = os.path.join(test_files, "short_trajectory.xtc")
    results = _spawn_cluster(_UNEVEN_WORKER, 4,
                             {"repo": REPO, "gro": gro, "xtc": xtc},
                             retries=1)
    for rc, out, err in results:
        assert rc == 0, f"worker failed:\n{out}\n{err}"
    line = next(ln for ln in results[0][1].splitlines()
                if ln.startswith("RESULT "))
    result = json.loads(line[len("RESULT "):])
    merged = np.asarray(result["coms"], np.float32)

    import jax.numpy as jnp

    from groan_rs_tpu.io.traj import traj_iter
    from groan_rs_tpu.ops import center as center_ops
    from groan_rs_tpu.system import System

    s = System.from_file(gro)
    coms = []
    for fb in traj_iter(s, xtc, batch_size=4).batches():
        g = jnp.asarray(fb.positions)
        box = jnp.asarray(fb.box_lengths())
        coms.append(np.asarray(center_ops.center(g, box[:, None, :])))
    single = np.concatenate(coms)
    assert result["n"] == single.shape[0] == 11
    np.testing.assert_allclose(merged, single, rtol=0, atol=1e-6)
