"""The runtime: the request plane's wire frames (`frames`) and RPC client
with reconnect, failover and wire negotiation (`master.MasterClient`), and
the native host runtime built by g++ at first use (`build`, `native`):
recordio shards (`recordio`), the in-process task master
(`master.TaskMaster`), the host memory pool (`allocator.HostPool`) and the
host optimizer (`optimizer.NativeOptimizer`)."""

from paddle_tpu_torch.runtime import recordio
from paddle_tpu_torch.runtime.allocator import HostPool
from paddle_tpu_torch.runtime.master import MasterClient, TaskMaster
from paddle_tpu_torch.runtime.optimizer import NativeOptimizer

__all__ = ["HostPool", "MasterClient", "NativeOptimizer", "TaskMaster", "recordio"]
