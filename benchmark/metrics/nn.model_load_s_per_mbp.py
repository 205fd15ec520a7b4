"""Seconds of the model's load per Mbp (the weights and a new
``IglooClassifier`` on each module call): the port's ``nn.model_load``
spans."""

from benchmark import program_spans


def read(ctx):
    return program_spans.seconds_per_mbp(ctx, "nn.model_load")
