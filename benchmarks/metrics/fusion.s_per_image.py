"""fusion.s_per_image: the harness's clock around run_stereo_fusion (the
maps read, the consistency masks, the points and the PLY) over the images
fused, in the window's finished jobs."""


def read(record):
    jobs = [j for j in record["jobs"] if "fusion_s" in j]
    n = sum(j["registered"] for j in jobs)
    return sum(j["fusion_s"] for j in jobs) / n if n else None
