"""Share of its roofline that the attention op reaches at the encoder's
calls: the sum of each call's bound over the sum of its device time (CUDA
events around the call the encoder makes, whatever kernel serves it), in %.
A call's bound is the larger of its bytes over 3.35 TB/s and its operations
over the dtype's peak, counted over the request's real windows and their
valid lengths (`yardstick.costs.attention_cost`)."""

from yardstick.costs import attention_cost, bound_s


def read(run):
    t = b = 0.0
    for seconds, c in run.calls.get("attention", []):
        lengths = c["lengths"].tolist()
        if c["rows"] is not None:
            lengths = lengths[:c["rows"]]
        nbytes, ops = attention_cost(lengths, c["heads"], c["head_dim"], c["in"], c["out"])
        if ops:
            t += seconds
            b += bound_s(nbytes, ops, c["in"])
    return 100.0 * b / t if t > 0 else None
