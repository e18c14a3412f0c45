"""The layer-sharded cluster (counterpart of cake_tpu/cluster/):
discovery, authentication, the wire protocol, topology and strategy,
weight streaming, and the master, worker and client. Pipeline-style layer
sharding over TCP: each node runs a contiguous range of layers, and a
hidden state hops from node to node once per token.

The wire bytes are the JAX package's, so a port master drives a JAX
worker and the other way round. The port needs neither msgpack nor yaml:
codec.py and topology.load_yaml read and write the subsets the protocol
and the topology format use.
"""
from . import faults
from .auth import AuthError, cluster_hash
from .client import RemoteStage, StageFailure
from .discovery import (WorkerAdvertiser, detect_capabilities,
                        discover_workers)
from .master import (ClusterDegradedError, DistributedTextModel, MasterSetup,
                     Stage, master_setup, plan_assignments)
from .strategy import DefaultStrategy, WorkerCapacity, estimate_layer_bytes
from .topology import Node, Topology, expand_layer_specs
from .worker import WorkerServer, run_worker
