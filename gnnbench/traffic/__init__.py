"""Traffic: the mixes (`<mix>.json`, data) and the families that generate
them (`<family>.py`, found by a mix's `family` key; `gnnbench.generate`)."""
