"""Share of the traced slice of offline serving in which the device ran nothing inside the predictor's spans `api.prepare` (upload, preprocess) and `api.to_host` (the copies of the top-k to the host)."""
from cnbench.spans import span_idle_share


def read(rec):
    return span_idle_share(rec, ("api.prepare", "api.to_host"))
