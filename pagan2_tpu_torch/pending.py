"""Names of the ROADMAP items that still have to be ported. Anything a
caller asks for that belongs to one of them raises `not_ported(...)`:
the port never ignores such a request silently."""

MULTI_GPU = "ROADMAP Queue 1 item 11 (multi-GPU)"


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError("%s is not ported to pagan2_tpu_torch yet: "
                               "%s" % (what, item))
