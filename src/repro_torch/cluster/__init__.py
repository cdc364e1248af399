"""OnePiece cluster layer: NodeManager orchestration, Paxos election,
proxies with fast-reject, workflow instances, transient databases,
regionally-autonomous Workflow Sets.
"""
from repro_torch.cluster.database import DatabaseInstance, ReplicatedDatabase
from repro_torch.cluster.instance import ResultDeliver, WorkflowInstance
from repro_torch.cluster.join import JOIN_DEAD, JOIN_PENDING, JoinTable, merge_partials
from repro_torch.cluster.node_manager import (
    ControlLoop,
    InstanceInfo,
    NMCluster,
    NodeManager,
    StageSpec,
    WorkflowSpec,
)
from repro_torch.cluster.paxos import Acceptor, LossyNetwork, Proposer, elect_primary
from repro_torch.cluster.proxy import Proxy, Rejected
from repro_torch.cluster.workflow_set import MultiSetFrontend, WorkflowSet

__all__ = [
    "Acceptor",
    "ControlLoop",
    "DatabaseInstance",
    "InstanceInfo",
    "JOIN_DEAD",
    "JOIN_PENDING",
    "JoinTable",
    "LossyNetwork",
    "merge_partials",
    "MultiSetFrontend",
    "NMCluster",
    "NodeManager",
    "Proposer",
    "Proxy",
    "Rejected",
    "ReplicatedDatabase",
    "ResultDeliver",
    "StageSpec",
    "WorkflowSet",
    "WorkflowSpec",
    "elect_primary",
]
