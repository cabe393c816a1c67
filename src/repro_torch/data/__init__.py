from repro_torch.data.synthetic import BinaryMnistStream, ImageClassStream, SuperResStream, TokenStream, shard  # noqa: F401
