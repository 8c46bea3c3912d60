"""The RPC layer and the supervised workers of the actor-learner scripts
(the port of embodied_tpu/remote/)."""

from .rpc import BatchServer, Client, Disconnected, Future, Server, free_port
from .proc import Process, Thread, run, setup
