#!/usr/bin/env python3
"""``control.py`` for a cell of a net with several heads (a ``serve_heads``
cell): the same readings, seed by seed, with the fp8 stand-in of
``reference/controls_heads.py`` (the int8 serve takes one head only).

    python3 portbench/control_heads.py --workload <cell> \
        --kind program|fp8 --seeds 11,12,13 [--seconds 2]
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import control  # noqa: E402
from portbench.reference import controls_heads  # noqa: E402


class HeadsControlContext(control.ControlContext):
    def program(self, name, build, **parts):
        if self.kind == "program":
            return build()
        return controls_heads.stand_in(self.kind, name, self, build, parts)


if __name__ == "__main__":
    # control.main builds its runs from this module-level name
    control.ControlContext = HeadsControlContext
    sys.exit(control.main())
