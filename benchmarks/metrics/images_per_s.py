"""images_per_s: images registered into the models of the captures that
finished in the window, over the window's seconds (from its start to the
end of the last capture that finished; one stopped at the deadline counts
neither its images nor its time)."""


def read(record):
    return record["registered"] / record["window_s"]
