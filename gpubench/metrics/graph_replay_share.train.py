"""graph_replay_share.train: the share of the program's training chunks of
the traced calls (its ``fit.chunk`` spans) that ran as a CUDA graph replay
(hold a ``graph.replay`` span), not eagerly or as a capture."""

from gpubench import idle_split


def read(r):
    spans = getattr(r.trace, "program_spans", None)
    if r.trace is None or not spans:
        return None
    return idle_split.replay_share(spans, "fit.chunk")
