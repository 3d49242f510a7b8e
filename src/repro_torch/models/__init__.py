"""The LM zoo: configuration, layers, the ``LM`` module and weight conversion."""
