"""Share of the traced training steps of the r18dcn cell in which no operation ran on the device."""
from cnbench.readers import idle_share as read  # noqa: F401
