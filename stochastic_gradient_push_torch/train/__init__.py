"""Train state, optimizer, LR schedule and the LM train step."""
