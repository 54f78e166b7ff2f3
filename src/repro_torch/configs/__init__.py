"""Published model configurations the port serves."""
