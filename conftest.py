"""Under pytest-xdist, each worker process takes its share of the cores.

Every worker would otherwise keep torch's default of one intra-op thread a
core, and N workers would run N threads a core, spinning against each
other.  The share is the cores this process may run on divided by the
number of workers, at least one; ``OMP_NUM_THREADS`` gets the same value
where it is not set, so that the processes a test starts inherit it.  A
pytest run without xdist workers is left as it is.
"""

import os

_workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _workers:
    _share = max(1, len(os.sched_getaffinity(0)) // int(_workers))
    os.environ.setdefault("OMP_NUM_THREADS", str(_share))

    import torch

    torch.set_num_threads(_share)
