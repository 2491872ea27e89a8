"""Milliseconds a search iteration takes in self-play: the traced segment's
length over the search iterations it ran, counted from the traffic (every
wave is one search of simulations / K iterations). None without a wave."""


def read(seg):
    if not seg.get("iterations"):
        return None
    return 1e3 * seg["window_s"] / seg["iterations"]
