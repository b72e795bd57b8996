#!/usr/bin/env python
"""nf-lint of the PyTorch port — `scripts/torch_nf_lint.py --json` exits
non-zero on any unsuppressed finding (CI gate; tier-1 runs the same
engine through tests/test_torch_lint.py).  All flags forward to
`python -m noahgameframe_tpu_torch.lint`; the rule catalogue is that
package's docstring (`--list-rules` prints it)."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from noahgameframe_tpu_torch.lint.__main__ import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
