"""frontend_images_per_s: images through extraction and matching over the
window, which runs from its start to the end of its last job (no job starts
after the deadline; the one in flight runs to its end)."""


def read(record):
    return sum(job["views"] for job in record["jobs"]) / record["window_s"]
