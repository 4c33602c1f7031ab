"""Multi-host launch scaffolding smoke: two OS processes join one JAX
runtime over the distributed coordinator and run collectives + the
halo-exchange front-end on a global (dp x sp) mesh.

Device-mesh replacement for the reference's multi-host story (separate
flowgraph processes over UDP/RF, SURVEY.md §2.5 multi-host row; tools/cmu_v3/).
On real clusters the same entry (`parallel.distributed.init_distributed`) is
called once per host; here each "host" is a subprocess with 4 virtual CPU
devices.
"""
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_mesh_smoke():
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update(JAX_COORDINATOR_ADDRESS=f"localhost:{port}",
                   JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(pid))
        # the worker forces CPU itself; it must not inherit this test
        # runner's virtual-device XLA flag (it sets its own count of 4)
        env.pop("XLA_FLAGS", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "ieee80211_phy.parallel._smoke_worker"],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=240)
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out[-2000:]}"
        assert f"SMOKE OK process {pid}/2 mesh dp=4 sp=2" in out


def test_single_process_fallback():
    from ieee80211_phy.parallel import distributed as dist
    for k in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
              "JAX_PROCESS_ID"):
        assert k not in os.environ
    assert dist.init_distributed() is False   # no-op, single process
    mesh = dist.make_global_phy_mesh(sp=2)    # local 8 virtual devices
    assert mesh.shape == {"dp": 4, "sp": 2}
    info = dist.process_summary()
    assert info["process_count"] == 1 and info["global_devices"] == 8
