"""Tutorial 4 — the actor model: offload work, marshal results back, on the
PyTorch port.

The port's counterpart of examples/tutorial4_actor.py (the reference's
Tutorial4 blurb, "use multiple cpus"): spawn an actor with a component,
post messages from the main loop, and receive results back on the main
thread during `execute()` — game state is only ever touched from the
main loop.  The actors are host threads and hold no device state;
``--device`` is accepted as every port tutorial accepts it.  The result
lines come in the order the two threads finish.

Run:  python examples/torch_tutorial4_actor.py
"""

from __future__ import annotations

import argparse
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from noahgameframe_tpu_torch.kernel import ActorComponent, ActorModule  # noqa: E402

MSG_HEAVY_MATH = 1


def main(device=None) -> None:
    actors = ActorModule(threads=2)

    comp = ActorComponent()

    def heavy_math(_msg_id: int, n: int) -> int:
        time.sleep(0.01)  # pretend this is expensive IO / crunching
        return sum(i * i for i in range(n))

    comp.on(MSG_HEAVY_MATH, heavy_math)
    actor_id = actors.require_actor(comp)

    main_thread = threading.get_ident()
    results = []

    def on_done(aid: int, msg_id: int, result) -> None:
        assert threading.get_ident() == main_thread, "must run on main loop"
        results.append(result)
        print(f"  result from actor {aid}: {result}")

    print("posting 3 jobs to the actor…")
    for n in (10, 100, 1000):
        actors.send_to_actor(actor_id, MSG_HEAVY_MATH, n, on_done)

    # the main loop: pump until all results are marshalled back
    while len(results) < 3:
        actors.execute()
        time.sleep(0.001)

    actors.shut()
    print("tutorial4 done")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    main(ap.parse_args().device)
