"""Training-side modules (the metrics so far; the train step arrives with
the training slice)."""
