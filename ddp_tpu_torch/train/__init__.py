"""Train and eval steps, resident epochs, evaluation and the trainer."""
