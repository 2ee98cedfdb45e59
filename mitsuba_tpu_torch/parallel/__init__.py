"""Multi-device and multi-process rendering over torch.distributed (port of
parallel/__init__.py).

The replacement of the reference's Scheduler + RemoteWorker fabric
(src/libcore/sched.cpp, sched_remote.cpp: work units over TCP/SSH): one
rank a device in a process group, the film data parallel over pixels
("dp") and the samples of a pixel split over "sp", the partial sums merged
by collectives (sched_remote.h:221-237). Each rank loads the scene itself
(the reference's resource registration, sched.h:281-292).
"""
from . import render_sharded as _rs_module  # noqa: F401
from .render_sharded import (  # noqa: F401
    make_mesh,
    render_sharded_jit,
    start_group,
    train_step,
)

# `render_sharded` (the function) would shadow the submodule of the same
# name in this namespace; reach the function through the submodule, or use
# render_sharded_jit.
