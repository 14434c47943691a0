"""Models of the port: ``CoVA`` and its ResNet backbones."""
