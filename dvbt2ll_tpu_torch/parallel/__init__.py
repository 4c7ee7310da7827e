"""Multi-device layer: device meshes of slots, sharded and multi-mux
transmitters, the symbol-sharded OFDM back-end."""
from .multimux import MultiMuxTransmitter, MuxChannel
from .sharding import (DeviceMesh, ShardedTransmitter, grids_symbol_sharded,
                       halo_windows, make_mesh)

__all__ = ["DeviceMesh", "MultiMuxTransmitter", "MuxChannel",
           "ShardedTransmitter", "grids_symbol_sharded", "halo_windows",
           "make_mesh"]
