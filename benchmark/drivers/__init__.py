"""One driver per kind of traffic (a traffic file's "kind"): its Session
makes the cell's set-up in __init__ and runs the measured window in
`window(seconds)`, filling `record` for the metric readers."""
