"""The whole int8 predict's share of the card's dense peaks, in percent:
one image's least forward time with each layer at its own dtype's peak
(``work_int8.ideal_s``: the int8 layers at 1979 TOPS, the stem and the
bias head convs at 989 TFLOP/s bf16) times the images per second of the
traced run's unprofiled window."""


def read(out):
    c = out.counters
    if not c.get("rate_img_per_s") or not c.get("ideal_s_per_image"):
        return None
    return c["ideal_s_per_image"] * c["rate_img_per_s"] * 100.0
