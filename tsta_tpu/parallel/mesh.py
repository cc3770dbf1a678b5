"""Device mesh construction.

The reference's only scheduler is a fixed-size pthread pool with a spin
barrier (pthreadpool/pthreadpool.c; driver loops psa/psa.c:619-639).  The
device equivalent is a ``jax.sharding.Mesh`` with two logical axes:

* ``data`` -- independent alignment problems (batched pairs / MSA reads),
  the analogue the reference lacks entirely (it is one-problem-per-process);
* ``seq``  -- column sharding of a single long problem (the analogue of
  the reference's anti-diagonal tile wavefront, SURVEY.md section 2 items
  2-3), used by parallel/longseq.py with neighbor exchange between devices.

Multi-host initialisation goes through ``jax.distributed`` when the env
provides a coordinator (no-op on a single host).
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def maybe_init_distributed() -> None:
    """Initialise jax.distributed if a coordinator is configured."""
    if os.environ.get("TSTA_COORDINATOR"):
        jax.distributed.initialize(
            coordinator_address=os.environ["TSTA_COORDINATOR"],
            num_processes=int(os.environ.get("TSTA_NUM_PROCESSES", "1")),
            process_id=int(os.environ.get("TSTA_PROCESS_ID", "0")),
        )


def make_mesh(data: Optional[int] = None, seq: int = 1,
              devices=None) -> Mesh:
    """Build a (data, seq) mesh over the available devices."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if data is None:
        data = n // seq
    if data < 1 or seq < 1 or data * seq > n:
        raise ValueError("mesh %dx%d needs %d devices, have %d"
                         % (data, seq, data * seq, n))
    dev_array = np.asarray(devices[:data * seq]).reshape(data, seq)
    return Mesh(dev_array, ("data", "seq"))


def data_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (batch) dim over the data axis."""
    return NamedSharding(mesh, P("data"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
