"""Wire schemas (proto3) for reference-compatible remoting.

The port's copy of nimblephysics_tpu/proto: message and field layout
match the reference's dart/proto/*.proto (field numbers are the wire
contract). Compiled at first use with protoc into a descriptor set;
message classes come from the official protobuf runtime.
"""

import os

PROTO_DIR = os.path.dirname(os.path.abspath(__file__))
