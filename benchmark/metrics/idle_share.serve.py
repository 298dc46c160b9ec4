"""Share of the traced slice of offline serving in which no operation ran on the device."""
from cnbench.readers import idle_share as read  # noqa: F401
