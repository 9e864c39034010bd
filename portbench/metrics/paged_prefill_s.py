"""The batcher's admission prefill a round (``engine/scheduler.py``,
``engine/kvcache.py``, ``engine/prefix_cache.py``): the sum of the rows'
``SchedResult.prefill_time_s``; the mean over the window's rounds."""


def read(run):
    if run["traffic"]["kv"] != "paged" or not run["rounds"]:
        return None
    rounds = run["rounds"]
    return sum(sum(x["prefill_s"] for x in r["rows"]) for r in rounds) / len(rounds)
