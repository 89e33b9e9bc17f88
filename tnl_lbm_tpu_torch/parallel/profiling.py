"""Halo traffic of a sharded run (counterpart of
``tnl_lbm_tpu/parallel/profiling.py``; reference lbm.hpp:238-279, the MPI
bytes and rates logged to the "profile" logger).

The exchange of a static lattice is known from its plan, so the bytes per
step come from the decomposition and the rate from the measured step
time.  The model's default link rate is an H100 SXM's published NVLink 4
figure (450 GB/s each way), the port's card; the exchange this repo
measured is in PERF.md.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tnl_lbm_tpu_torch.sim.config import Domain

#: H100 SXM data sheet: NVLink 4 bandwidth each way
H100_NVLINK_GBPS = 450.0
#: an inter-host link for the multi-host tier: ASSUMED, a 200 Gbit/s NIC;
#: no run of this repo has measured one
HOST_LINK_GBPS = 25.0


@dataclasses.dataclass
class HaloTraffic:
    """The halo bytes and slabs a device exchanges per step, or per pair
    where ``steps_per_exchange`` is 2 (the sharded pair's exchange: the
    fields keep their names, per exchange)."""
    bytes_per_step_per_device: int
    messages_per_step_per_device: int
    n_devices: int
    steps_per_exchange: int = 1

    def log_line(self, steps: int, seconds: float) -> str:
        unit = "step" if self.steps_per_exchange == 1 else "pair"
        total = self.bytes_per_step_per_device * steps / self.steps_per_exchange
        gbps = total / seconds / 1e9 if seconds > 0 else 0.0
        return (f"halo traffic: {self.bytes_per_step_per_device / 1e6:.2f} MB/{unit}/device, "
                f"{self.messages_per_step_per_device} slabs/{unit}, "
                f"{gbps:.2f} GB/s/device over {steps} steps")


def subset_exchange_ok(domain: Domain) -> bool:
    """Whether the plain sharded step exchanges direction subsets (Bouzidi
    pulls +c offsets and takes every component; the kernels' sharded steps
    always copy whole slabs)."""
    return domain.bouzidi is None


def predicted_weak_scaling(domain: Domain, plan, step_seconds: float,
                           link_gbps: float = H100_NVLINK_GBPS, overlapped: bool = True,
                           subset: bool | None = None, hosts: int = 1,
                           host_link_gbps: float = HOST_LINK_GBPS) -> float:
    """The weak-scaling efficiency of a sharded run predicted from the
    measured time of one step on one device's block and the link time of
    its halo slabs: t / max(t, t_halo) when the exchange overlaps the
    compute, t / (t + t_halo) when it does not.  Each sharded axis has its
    own links, so the busiest axis sets t_halo.  ``hosts > 1``: the
    outermost sharded axis spans the hosts, and its host-boundary faces take
    ``host_link_gbps``."""
    if subset is None:
        subset = subset_exchange_ok(domain)
    local = plan.local_shape(domain)
    counts = plan.counts
    sharded_axes = [a for a, n in enumerate(counts) if n > 1]
    outer = sharded_axes[0] if sharded_axes else None
    worst = 0.0
    for a in sharded_axes:
        slab_sites = int(np.prod([s for i, s in enumerate(local) if i != a]))
        q_face = int((np.asarray(domain.lat.c)[:, a] == 1).sum()) if subset else domain.lat.Q
        axis_bytes = 2 * q_face * slab_sites * 4
        rate = link_gbps
        if hosts > 1 and a == outer and counts[a] >= hosts:
            rate = host_link_gbps
            axis_bytes //= 2
        worst = max(worst, axis_bytes / (rate * 1e9))
    if overlapped:
        return step_seconds / max(step_seconds, worst)
    return step_seconds / (step_seconds + worst)


def halo_traffic(domain: Domain, plan, itemsize: int = 4, subset: bool = True) -> HaloTraffic:
    """The halo bytes per step and device of a plan: two 1-wide face slabs
    per sharded axis, of the components that cross the cut with ``subset``
    (9 of 27 on D3Q27, 3 of 9 on D2Q9) or of all of them."""
    local = plan.local_shape(domain)
    lat = domain.lat
    total_bytes = 0
    messages = 0
    for a, n in enumerate(plan.counts):
        if n == 1:
            continue
        q_face = int((np.asarray(lat.c)[:, a] == 1).sum()) if subset else lat.Q
        slab_sites = int(np.prod([s for i, s in enumerate(local) if i != a]))
        total_bytes += 2 * q_face * slab_sites * itemsize
        messages += 2
    return HaloTraffic(bytes_per_step_per_device=total_bytes,
                       messages_per_step_per_device=messages, n_devices=plan.n_shards)


def pair_halo_traffic(domain: Domain, plan, itemsize: int = 4) -> HaloTraffic:
    """The halo bytes per pair and device of the sharded pair
    (``parallel/sharded.py make_sharded_fused_pair2_aa``): two 2-wide slabs
    of every component per sharded axis, each spanning the whole haloed
    block across the other axis (the y slabs carry the x halos: JAX
    ``_fill_axis``), in the state's store dtype (``itemsize``)."""
    X, Y, Z = plan.local_shape(domain)
    Q = domain.lat.Q
    total_bytes = 0
    messages = 0
    for a, n in enumerate(plan.counts[:2]):
        if n == 1:
            continue
        total_bytes += 2 * Q * 2 * ((Y if a == 0 else X) + 4) * Z * itemsize
        messages += 2
    return HaloTraffic(bytes_per_step_per_device=total_bytes,
                       messages_per_step_per_device=messages, n_devices=plan.n_shards,
                       steps_per_exchange=2)
