"""Runtime and DistributedRuntime, a copy of ``dynamo_tpu/runtime/runtime.py``.

``Runtime`` owns the process's root cancellation; ``DistributedRuntime``
adds the control-plane client (DCP), the primary lease (the worker's
identity and liveness, renewed by a :class:`KeepaliveThread`) and the
lazily created TCP response-plane server. The reference's ``Worker`` /
``dynamo_worker`` entry-point wrappers are not part of the port: the
launcher (``dynamo_tpu_torch/run.py``) is its entry point.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from .component import Namespace
from .config import RuntimeConfig, env_str
from .dcp_client import DcpClient, KeepaliveThread
from .dcp_server import DcpServer
from .tcp import TcpStreamServer

log = logging.getLogger("dynamo_tpu_torch.runtime")

DEFAULT_DCP = env_str("DYN_DCP_ADDRESS", "127.0.0.1:6650")


class Runtime:
    """Process-local execution context: the settings and the root
    shutdown event."""

    def __init__(self, config: Optional[RuntimeConfig] = None):
        self.config = config or RuntimeConfig.from_settings()
        self._shutdown = asyncio.Event()

    @property
    def shutdown_event(self) -> asyncio.Event:
        return self._shutdown

    def shutdown(self) -> None:
        self._shutdown.set()


class DistributedRuntime:
    """Runtime, control-plane connectivity and worker identity.

    ``primary_lease`` doubles as the worker/instance id, as the reference
    uses its etcd lease id.
    """

    def __init__(self, runtime: Runtime, dcp: DcpClient, lease: int):
        self.runtime = runtime
        self.dcp = dcp
        self.primary_lease = lease
        self._tcp_server: Optional[TcpStreamServer] = None
        self._tcp_lock = asyncio.Lock()
        self._keepalive: Optional[KeepaliveThread] = None
        self._embedded_server: Optional[DcpServer] = None

    @classmethod
    async def attach(
        cls,
        dcp_address: Optional[str] = None,
        runtime: Optional[Runtime] = None,
        lease_ttl: Optional[float] = None,
    ) -> "DistributedRuntime":
        """Connect to the control plane and acquire the primary lease."""
        runtime = runtime or Runtime()
        address = dcp_address or runtime.config.dcp_address or DEFAULT_DCP
        lease_ttl = lease_ttl if lease_ttl is not None \
            else runtime.config.lease_ttl
        dcp = await DcpClient.connect(address)
        lease = await dcp.lease_grant(lease_ttl)
        self = cls(runtime, dcp, lease)
        # a renewal thread with its own connection: the serving process
        # blocks its loop for multiples of the TTL (graph capture, long
        # prefill chunks), and a loop-resident renewal would let the
        # lease and every record under it expire
        self._keepalive = KeepaliveThread(address, lease, lease_ttl)
        return self

    @classmethod
    async def detached(cls, runtime: Optional[Runtime] = None,
                       lease_ttl: Optional[float] = None
                       ) -> "DistributedRuntime":
        """Single-process mode: embed a DCP server in this process (used
        by tests and by the launcher when no control plane is named)."""
        server = await DcpServer.start("127.0.0.1", 0)
        drt = await cls.attach(server.address, runtime, lease_ttl)
        drt._embedded_server = server
        return drt

    @property
    def instance_id(self) -> int:
        return self.primary_lease

    def namespace(self, name: str) -> Namespace:
        return Namespace(self, name)

    async def tcp_server(self) -> TcpStreamServer:
        """The lazily created response-plane listener."""
        async with self._tcp_lock:
            if self._tcp_server is None:
                self._tcp_server = await TcpStreamServer.start()
            return self._tcp_server

    async def shutdown(self) -> None:
        self.runtime.shutdown()
        if self._keepalive:
            # cancel() joins the thread, which may sit in a renewal RPC for
            # up to its timeout: run it off the loop
            await asyncio.get_running_loop().run_in_executor(
                None, self._keepalive.cancel)
        try:
            await self.dcp.lease_revoke(self.primary_lease)
        except Exception:  # noqa: BLE001 — best effort; the TTL is the
            # backstop
            log.debug("lease revoke failed during shutdown", exc_info=True)
        if self._tcp_server:
            await self._tcp_server.stop()
        await self.dcp.close()
        if self._embedded_server is not None:
            await self._embedded_server.stop()
