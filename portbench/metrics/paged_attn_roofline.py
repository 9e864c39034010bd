"""B3 and B4 (``ops/paged_attention.py``) against their roofline: the
least time the traced rounds' paged attention launches could take
(``roofline.paged_attention_bound_s``) over the device time of those
kernels and of their split-KV combine, in %."""

from portbench import roofline


def read(run):
    trace = run.get("trace")
    if not trace or run["traffic"]["kv"] != "paged":
        return None
    device = sum(s for n, s in trace["device_ops"] if roofline.attention_kind(n) in ("paged", "combine"))
    L = run["config"]["num_hidden_layers"]
    bound = sum(
        roofline.paged_attention_bound_s(
            run["config"], r["rows"], r["launches"].get("paged_decode_attention", 0) // L,
            r["launches"].get("paged_decode_attention_mq", 0) // L, run["gamma"])
        for r in run["rounds"] if r["traced"])
    if not device or not bound:
        return None
    return 100.0 * bound / device
