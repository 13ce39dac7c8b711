"""One reader a metric: ``metrics/<name>.py`` holds ``read(result, spec)``,
which returns the metric's value, or None where the run gave it nothing
to read (the metric is then left out of the result line; a share of a
roofline or of a peak is never given as 0)."""
