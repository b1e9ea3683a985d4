"""Run `chip_smoke.py`'s SLAM loop phase once, from the tree in the current
directory, on the card, and print its `ms_per_frame` and
`ms_per_train_step` as one JSON line (the phase's own lines before it).

To compare two trees on one card, unpack each (`git archive`) into a
directory and run this script from each in turns in one call:

    for d in parent change change parent ...; do
        (cd build/$d && python3 /path/to/tools/slam_phase_once.py | tail -n 1)
    done
"""

import json
import os
import sys

sys.path.insert(0, os.getcwd())

import chip_smoke  # noqa: E402  (the tree under test's)
from sags_tpu_torch import resolve_device  # noqa: E402
from sags_tpu_torch.ops import _build  # noqa: E402
from sags_tpu_torch.ops import binning, composite, sort, windowed  # noqa: E402,F401  (register kernels)


def main() -> int:
    device = resolve_device("cuda")
    _build.build_all()
    _, _, _, _, classic = chip_smoke.slam_phase(device)
    print(json.dumps({"tree": os.path.basename(os.getcwd()),
                      "ms_per_frame": classic["ms_per_frame"],
                      "ms_per_train_step": classic["ms_per_train_step"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
