"""Device-topology description for the placement planner (the port's copy
of `paddle_tpu/autoshard/topology.py`, its fields and its JSON / env keys
unchanged, so plan tables and topology specs read the same in both
packages).

A `Topology` is everything the cost model needs to know about the
hardware WITHOUT touching it: device count, memory per device, and the
two interconnect bandwidth tiers. The field names are the JAX package's:
`ici_gbps` is the fast tier inside one domain and `dcn_gbps` the slow
tier between domains; `ici_domain` is the devices of one domain. The
cost of a collective depends on which tier its mesh axis spans: the
planner weights each axis's collective bytes by `ici_gbps / axis_bw`, so
an axis forced across the slow tier pays its bandwidth ratio.

The defaults describe NVIDIA H100 SXM nodes. They are datasheet
constants, not measurements: 80 GB of HBM3 a device; NVLink 4 at 450
GB/s a direction as the fast tier; the inter-node network at 50 GB/s
(400 Gb/s NDR InfiniBand, one adapter a GPU) as the slow tier; 8 GPUs a
node as the domain. Only the bandwidths' ratio enters the cost model.
The JAX package's defaults are a TPU v5e's (16 GB, 400 / 25 GB/s, one
slice); pass them explicitly to plan as it does.

Axis -> tier mapping follows how `parallel.mesh.build_mesh` lays the ranks
out: a (batch, model, pipe) DeviceMesh over ranks 0..n-1, so 'pipe' is
innermost (stride 1), 'model' next (stride pipe), 'batch' outermost
(stride model*pipe). Ranks `[k*ici_domain, (k+1)*ici_domain)` share a
domain; an axis whose footprint `stride * extent` exceeds `ici_domain`
crosses domains and is weighted at the slow tier.

Pure stdlib on purpose: the planner runs on hosts with no device, and the
JSON / env constructors are what the supervisor's shrink policy and the
planner CLI share.
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple

__all__ = ["Topology", "TOPOLOGY_ENV", "H100_HBM_GB", "H100_NVLINK_GBPS",
           "H100_NETWORK_GBPS", "H100_NODE_GPUS"]

TOPOLOGY_ENV = "PADDLE_TPU_TOPOLOGY"

# datasheet constants of an H100 SXM node (not measured)
H100_HBM_GB = 80.0
H100_NVLINK_GBPS = 450.0
H100_NETWORK_GBPS = 50.0
H100_NODE_GPUS = 8


class Topology(NamedTuple):
    """Static hardware description. Bandwidths are per-direction GB/s;
    only their RATIO enters the cost model."""

    chips: int
    hbm_gb_per_chip: float = H100_HBM_GB
    ici_gbps: float = H100_NVLINK_GBPS
    dcn_gbps: float = H100_NETWORK_GBPS
    # devices per fast-tier domain (one node); 0: the whole job is one
    # domain
    ici_domain: int = H100_NODE_GPUS

    @property
    def hbm_bytes_per_chip(self) -> float:
        return self.hbm_gb_per_chip * 1e9

    @property
    def domain(self) -> int:
        return self.ici_domain if self.ici_domain > 0 else self.chips

    # -- constructors -----------------------------------------------------
    @classmethod
    def single_slice(cls, chips: int, hbm_gb: float = H100_HBM_GB) -> "Topology":
        """One domain over every device."""
        return cls(chips=int(chips), hbm_gb_per_chip=float(hbm_gb), ici_domain=0)

    @classmethod
    def from_spec(cls, spec: str) -> "Topology":
        """`"chips=8,hbm_gb=80,ici_gbps=450,dcn_gbps=50,ici_domain=8"`
        (any subset; chips required) or a path to a JSON file with the
        same keys."""
        spec = spec.strip()
        if os.path.exists(spec) or spec.endswith(".json"):
            with open(spec) as f:
                data = json.load(f)
            return cls.from_dict(data)
        data = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            k, _, v = part.partition("=")
            data[k.strip()] = float(v)
        return cls.from_dict(data)

    @classmethod
    def from_dict(cls, data: dict) -> "Topology":
        if "chips" not in data:
            raise ValueError(f"topology spec needs 'chips': {data!r}")
        return cls(
            chips=int(data["chips"]),
            hbm_gb_per_chip=float(data.get("hbm_gb", data.get("hbm_gb_per_chip", H100_HBM_GB))),
            ici_gbps=float(data.get("ici_gbps", H100_NVLINK_GBPS)),
            dcn_gbps=float(data.get("dcn_gbps", H100_NETWORK_GBPS)),
            ici_domain=int(data.get("ici_domain", H100_NODE_GPUS)),
        )

    @classmethod
    def from_env(cls, default_chips: int = None) -> "Topology | None":
        """PADDLE_TPU_TOPOLOGY, else H100 nodes over `default_chips`
        (None with neither)."""
        spec = os.environ.get(TOPOLOGY_ENV)
        if spec:
            return cls.from_spec(spec)
        if default_chips:
            return cls(chips=int(default_chips))
        return None

    def to_dict(self) -> dict:
        return {
            "chips": self.chips,
            "hbm_gb_per_chip": self.hbm_gb_per_chip,
            "ici_gbps": self.ici_gbps,
            "dcn_gbps": self.dcn_gbps,
            "ici_domain": self.ici_domain,
        }

    # -- axis tiers -------------------------------------------------------
    def axis_tier_weights(self, axis_sizes: dict) -> dict:
        """{axis: bandwidth weight} for a (batch, model, pipe) shape on
        this topology: 1.0 for an axis whose links stay inside one
        domain, `ici_gbps / dcn_gbps` (> 1) for one that crosses
        domains. Size-1 axes carry no traffic; weight 1.0."""
        pipe = int(axis_sizes.get("pipe", 1))
        model = int(axis_sizes.get("model", 1))
        strides = {
            "pipe": 1,
            "model": pipe,
            "batch": pipe * model,
        }
        dcn_weight = max(self.ici_gbps / self.dcn_gbps, 1.0)
        out = {}
        for ax in ("batch", "model", "pipe"):
            n = int(axis_sizes.get(ax, 1))
            footprint = strides[ax] * n
            out[ax] = 1.0 if (n <= 1 or footprint <= self.domain) else dcn_weight
        return out
