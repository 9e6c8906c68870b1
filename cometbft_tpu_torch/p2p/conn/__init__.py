"""Authenticated, multiplexed connections (reference: p2p/conn/)."""

from .secret_connection import SecretConnection  # noqa: F401
from .connection import ChannelDescriptor, MConnection  # noqa: F401
