"""Language-model pipelines (counterpart of
``keystone_tpu/pipelines/nlp``)."""
