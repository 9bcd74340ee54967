"""host_idle_share.train: the share of the traced window in which no work
ran on the card while the host was inside the program's ``fit``, in a span
of the program's own other than ``fetch`` (the one copy to the host, a wait
on the card): ``idle_split.py`` charges each instant of an idle interval to
the innermost span the host was in. At most ``device_idle_share.train`` on
the same trace."""

from gpubench import idle_split


def read(r):
    spans = getattr(r.trace, "program_spans", None)
    if r.trace is None or not spans:
        return None
    return idle_split.host_idle_share(r.trace, spans, "fit")
