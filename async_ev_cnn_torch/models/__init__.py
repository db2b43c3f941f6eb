"""Models of the port: the event YOLO and its detection head."""
