"""L5 distributed communication backend (reference: p2p/).

Port of cometbft_tpu/p2p/ without ``pex/``, ``fuzz.py`` and
``suspicion.py``, which come with the node.
"""

from .key import NodeKey, node_id_from_pubkey  # noqa: F401
from .node_info import NodeInfo  # noqa: F401
from .base_reactor import Reactor, ChannelDescriptor  # noqa: F401
from .peer import Peer  # noqa: F401
from .switch import Switch  # noqa: F401
from .transport import MultiplexTransport  # noqa: F401
