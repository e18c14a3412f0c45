"""The layer-sharded cluster (counterpart of cake_tpu/cluster/):
discovery, authentication, the wire protocol, topology and strategy,
weight streaming, and the master, worker and client. Pipeline-style layer
sharding over TCP: each node runs a contiguous range of layers, and a
hidden state hops from node to node once per token.

The wire bytes are the JAX package's, so a port master drives a JAX
worker and the other way round. The port needs neither msgpack nor yaml:
codec.py and topology.load_yaml read and write the subsets the protocol
and the topology format use.

The names below load with their submodule on first use (PEP 562), so
`cluster.discovery` alone, which the fleet router's UDP discovery reads,
imports without torch.
"""
import importlib

# name -> the submodule that defines it
_LAZY = {
    "AuthError": "auth", "cluster_hash": "auth",
    "RemoteStage": "client", "StageFailure": "client",
    "WorkerAdvertiser": "discovery", "detect_capabilities": "discovery",
    "discover_workers": "discovery",
    "ClusterDegradedError": "master", "DistributedTextModel": "master",
    "MasterSetup": "master", "Stage": "master", "master_setup": "master",
    "plan_assignments": "master",
    "DefaultStrategy": "strategy", "WorkerCapacity": "strategy",
    "estimate_layer_bytes": "strategy",
    "Node": "topology", "Topology": "topology",
    "expand_layer_specs": "topology",
    "WorkerServer": "worker", "run_worker": "worker",
}

__all__ = ["faults", *_LAZY]


def __getattr__(name: str):
    if name == "faults":
        return importlib.import_module(f"{__name__}.faults")
    if name in _LAZY:
        value = getattr(importlib.import_module(
            f"{__name__}.{_LAZY[name]}"), name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
