# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: dra.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\tdra.proto\x12\nv1beta1dra\"5\n\x05\x43laim\x12\x0b\n\x03uid\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x11\n\tnamespace\x18\x03 \x01(\t\"@\n\x1bNodePrepareResourcesRequest\x12!\n\x06\x63laims\x18\x01 \x03(\x0b\x32\x11.v1beta1dra.Claim\"Z\n\x06\x44\x65vice\x12\x10\n\x08requests\x18\x01 \x03(\t\x12\x11\n\tpool_name\x18\x02 \x01(\t\x12\x13\n\x0b\x64\x65vice_name\x18\x03 \x01(\t\x12\x16\n\x0e\x63\x64i_device_ids\x18\x04 \x03(\t\"Q\n\x1bNodePrepareResourceResponse\x12#\n\x07\x64\x65vices\x18\x01 \x03(\x0b\x32\x12.v1beta1dra.Device\x12\r\n\x05\x65rror\x18\x02 \x01(\t\"\xbc\x01\n\x1cNodePrepareResourcesResponse\x12\x44\n\x06\x63laims\x18\x01 \x03(\x0b\x32\x34.v1beta1dra.NodePrepareResourcesResponse.ClaimsEntry\x1aV\n\x0b\x43laimsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\x36\n\x05value\x18\x02 \x01(\x0b\x32\'.v1beta1dra.NodePrepareResourceResponse:\x02\x38\x01\"B\n\x1dNodeUnprepareResourcesRequest\x12!\n\x06\x63laims\x18\x01 \x03(\x0b\x32\x11.v1beta1dra.Claim\".\n\x1dNodeUnprepareResourceResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\"\xc2\x01\n\x1eNodeUnprepareResourcesResponse\x12\x46\n\x06\x63laims\x18\x01 \x03(\x0b\x32\x36.v1beta1dra.NodeUnprepareResourcesResponse.ClaimsEntry\x1aX\n\x0b\x43laimsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\x38\n\x05value\x18\x02 \x01(\x0b\x32).v1beta1dra.NodeUnprepareResourceResponse:\x02\x38\x01\x32\xeb\x01\n\tDRAPlugin\x12k\n\x14NodePrepareResources\x12\'.v1beta1dra.NodePrepareResourcesRequest\x1a(.v1beta1dra.NodePrepareResourcesResponse\"\x00\x12q\n\x16NodeUnprepareResources\x12).v1beta1dra.NodeUnprepareResourcesRequest\x1a*.v1beta1dra.NodeUnprepareResourcesResponse\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'dra_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _NODEPREPARERESOURCESRESPONSE_CLAIMSENTRY._options = None
  _NODEPREPARERESOURCESRESPONSE_CLAIMSENTRY._serialized_options = b'8\001'
  _NODEUNPREPARERESOURCESRESPONSE_CLAIMSENTRY._options = None
  _NODEUNPREPARERESOURCESRESPONSE_CLAIMSENTRY._serialized_options = b'8\001'
  _CLAIM._serialized_start=25
  _CLAIM._serialized_end=78
  _NODEPREPARERESOURCESREQUEST._serialized_start=80
  _NODEPREPARERESOURCESREQUEST._serialized_end=144
  _DEVICE._serialized_start=146
  _DEVICE._serialized_end=236
  _NODEPREPARERESOURCERESPONSE._serialized_start=238
  _NODEPREPARERESOURCERESPONSE._serialized_end=319
  _NODEPREPARERESOURCESRESPONSE._serialized_start=322
  _NODEPREPARERESOURCESRESPONSE._serialized_end=510
  _NODEPREPARERESOURCESRESPONSE_CLAIMSENTRY._serialized_start=424
  _NODEPREPARERESOURCESRESPONSE_CLAIMSENTRY._serialized_end=510
  _NODEUNPREPARERESOURCESREQUEST._serialized_start=512
  _NODEUNPREPARERESOURCESREQUEST._serialized_end=578
  _NODEUNPREPARERESOURCERESPONSE._serialized_start=580
  _NODEUNPREPARERESOURCERESPONSE._serialized_end=626
  _NODEUNPREPARERESOURCESRESPONSE._serialized_start=629
  _NODEUNPREPARERESOURCESRESPONSE._serialized_end=823
  _NODEUNPREPARERESOURCESRESPONSE_CLAIMSENTRY._serialized_start=735
  _NODEUNPREPARERESOURCESRESPONSE_CLAIMSENTRY._serialized_end=823
  _DRAPLUGIN._serialized_start=826
  _DRAPLUGIN._serialized_end=1061
# @@protoc_insertion_point(module_scope)
