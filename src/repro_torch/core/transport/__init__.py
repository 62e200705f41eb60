"""The transport substrate (DESIGN.md §3, §10, §13): packed transfer
commands in bounded FIFO rings, CPU proxies, the ordered/unordered network
model and the EP executor that runs LL and HT over them, on the host.  The
port of ``repro.core.transport``; exports what the reference exports."""
from repro_torch.core.transport.codec import (WIRE_DTYPES, WireCodec,
                                              dequantize_blocked, get_codec,
                                              quantize_blocked)
from repro_torch.core.transport.ep_executor import (EPWorld, np_grouped_swiglu,
                                                    np_swiglu)
from repro_torch.core.transport.fifo import (FLAG_FENCE, CmdColumns,
                                             FifoChannel, Op, TransferCmd,
                                             pack_cmds, unpack_cmds)
from repro_torch.core.transport.proxy import Proxy, SymmetricMemory
from repro_torch.core.transport.semantics import (ControlBuffer, GuardTable,
                                                  ImmKind, pack_imm,
                                                  unpack_imm)
from repro_torch.core.transport.simulator import Message, NetConfig, Network
from repro_torch.core.transport.wire_format import (FENCE_COUNT_MAX,
                                                    IMM_VAL_MAX,
                                                    N_CHANNELS_MAX, SEQ_MOD,
                                                    SRD_DISPLACEMENT_BOUND,
                                                    ProtocolError)

__all__ = ["EPWorld", "np_grouped_swiglu", "np_swiglu", "FLAG_FENCE",
           "CmdColumns", "FifoChannel", "Op", "TransferCmd", "pack_cmds",
           "unpack_cmds", "Proxy", "SymmetricMemory", "ControlBuffer",
           "GuardTable", "ImmKind", "pack_imm", "unpack_imm", "Message",
           "NetConfig", "Network", "WIRE_DTYPES", "WireCodec", "get_codec",
           "quantize_blocked", "dequantize_blocked", "ProtocolError",
           "N_CHANNELS_MAX", "SEQ_MOD", "IMM_VAL_MAX", "FENCE_COUNT_MAX",
           "SRD_DISPLACEMENT_BOUND"]
