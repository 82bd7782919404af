"""The FPN neck and heads of a net with several heads: device ms a batch of
the work launched under the program's span ``ssp.net.neck`` (the layers
after the last shortcut, through the last head conv), from eager serving
calls on one pool batch after the traced window
(``runners/serve_heads.py``)."""


def read(r):
    if r.get("kind") != "serve" or r.get("trace") is None:
        return None
    return r.get("neck_ms")
