"""Regenerate the committed Unity client-binding artifacts with the port.

Writes clients/unity/ (or ``--out DIR``): the generated C# message binding
(NFMsg.cs), the golden wire vectors (NFMsgGolden.tsv, one deterministic
encode of every declared message by the port's codec) and the replay
harness (NFMsgGoldenTest.cs).  The port's emitters write the same bytes as
scripts/emit_client_vectors.py.  Run from the repo root:

    python scripts/torch_emit_client_vectors.py
"""

from __future__ import annotations

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from noahgameframe_tpu_torch.tools.emit_cs_sdk import emit_cs  # noqa: E402
from noahgameframe_tpu_torch.tools.golden_vectors import (  # noqa: E402
    emit_cs_harness,
    emit_vectors,
)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=pathlib.Path,
                    default=pathlib.Path(__file__).resolve().parent.parent / "clients" / "unity")
    out = ap.parse_args().out
    out.mkdir(parents=True, exist_ok=True)
    (out / "NFMsg.cs").write_text(emit_cs())
    (out / "NFMsgGolden.tsv").write_text(emit_vectors())
    (out / "NFMsgGoldenTest.cs").write_text(emit_cs_harness())
    for p in sorted(out.iterdir()):
        print(p, p.stat().st_size, "bytes")


if __name__ == "__main__":
    main()
