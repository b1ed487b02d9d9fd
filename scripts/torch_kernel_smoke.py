"""The port's kernel smoke on a CUDA card (counterpart of scripts/tpu_smoke.py).

Builds every kernel of ttt_video_dit_torch/csrc/ (one nvcc a source, all at
once), then runs ttt_video_dit_torch/utils/selftest.py:kernel_selftest: every
kernel against its plain PyTorch version at small discriminating shapes,
each check printed with its error and tolerance. A benchmark runs the same
self-test before it times anything; this script is its manual entry point.

Run: python scripts/torch_kernel_smoke.py
Exit 0 and "GPU_SMOKE_OK" when every check holds, exit 1 and
"GPU_SMOKE_FAIL" when one does not; a machine without a CUDA card is refused
(exit 2, no result line).
"""

import os.path as osp
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

sys.path.append(osp.dirname(osp.dirname(osp.abspath(__file__))))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_smoke: needs a CUDA card (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    from ttt_video_dit_torch.ops import _build
    from ttt_video_dit_torch.utils.selftest import kernel_selftest

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[:1]
    sources = sorted(p.stem for p in _build.CSRC_DIR.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(_build.load, sources))
    print(f"built {', '.join(sources)} in {time.perf_counter() - t0:.1f} s")
    result = kernel_selftest(torch.device("cuda"), log=print)
    print(f"{len(result['checks'])} checks in {result['seconds']:.2f} s on {card[0] if card else 'an unnamed card'}")
    print("GPU_SMOKE_OK" if result["ok"] else "GPU_SMOKE_FAIL")
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
