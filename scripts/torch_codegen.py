#!/usr/bin/env python
"""Run the port's config codegen pipeline (GenerateConfigXML.sh equivalent).

    python scripts/torch_codegen.py --in config_src/ --out NFDataCfg/

Reads CSV/XLSX class sheets (+ `<Class>.ini.csv` element rows) and emits
reference-format Struct/Ini XML, the name-constant modules (Python, C#,
Java) and SQL DDL.  The same CLI as scripts/codegen.py, on
noahgameframe_tpu_torch/tools/codegen.py (host code: it emits the same
files whichever package runs it).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from noahgameframe_tpu_torch.tools import CodegenPipeline  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--in", dest="in_dir", required=True, type=Path)
    ap.add_argument("--out", dest="out_dir", required=True, type=Path)
    args = ap.parse_args()
    report = CodegenPipeline(args.in_dir, args.out_dir).run()
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
