"""paddle_tpu_torch.distributed — the socket store the serving fleet
runs its membership on. The process groups, collectives and the mesh
of the JAX package's ``distributed`` are not ported yet."""

from .tcp_store import (StoreUnavailable, TCPMembership,  # noqa: F401
                        TCPStoreClient, TCPStoreServer)

__all__ = ["StoreUnavailable", "TCPMembership", "TCPStoreClient",
           "TCPStoreServer"]
