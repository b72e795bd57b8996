"""The port's deployment shape, for real: one role per PROCESS.

tests/test_multiprocess_cluster.py on the port's launcher, through
``chip_smoke.five_processes`` (phase (n)'s script, here on the CPU): five
`scripts/torch_run_role.py` subprocesses from a shared Server.xml, the
game's world on ``--device cpu`` with a journal and a checkpoint dir; the
master's dashboard lists the whole cluster, a real client goes through
the full login pipeline over real sockets into the game process and
chats, then the game stops and its journal replays digest-clean from the
game's first checkpoint through ``torch_run_role.py --role game
--replay``.  The roles report and re-dial every 0.5 s
(``--keepalive-seconds``) instead of the library's 10 s."""

import chip_smoke as cs
from test_torch_parity import one_intra_op_thread  # noqa: F401


def test_five_process_cluster_bringup_login_and_replay(tmp_path):
    out = cs.five_processes(str(tmp_path), "cpu")
    assert out["servers"] == ["game", "login", "proxy", "world"]
    assert list(out["replay"]) == ["cpu"]
    assert out["replay"]["cpu"]["summary"].startswith("REPLAY OK")
