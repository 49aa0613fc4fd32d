"""Fleet autopilot: only the windowed tails the KV router reads so far
(``tails.TailTracker``)."""
